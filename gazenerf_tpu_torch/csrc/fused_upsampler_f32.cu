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
// cotangents) is f32, as the TPU kernel's f32 mode has it.  A product's
// output is a chain of f32 fused multiply-adds in increasing k from zero
// (past kChainK, chunks of such chains added in order), the bias added
// after; the stencil and its adjoint are
// csrc/phase_stencil.cuh's (K5 / K6 at f32).  The weight gradients sum the
// pixels in slices of kSliceRows rows, each slice in stages of kStageK rows
// summed from zero and added to the slice's sum, and the slices pairwise;
// no atomic makes the order vary (two launches give the same bits).  The
// epilogues round as the plain version does (no contraction of a multiply
// into a later add).
//
// Bound, per block at B=2 on the H100 (67 TFLOP/s of f32 outside the tensor
// cores, 3.35 TB/s).  Forward P (10 F^2 + 4 F F3) multiply-adds, ~6.5 G a
// block: 0.195 / 0.195 / 0.192 ms of operations at block0 / 1 / 2, against
// 4P (14F + 12 F3) bytes with h1, z and z3 through device memory: 169 /
// 337 / 671 MB, 0.05 / 0.10 / 0.20 ms (at block0 h1, 17 MB, and z, 34 MB,
// stay in the 50 MB L2).  Backward P (30 F^2 + 8 F F3) multiply-adds (the
// recompute of h1 and z, three data and three weight-gradient products):
// 0.553 / 0.553 / 0.545 ms, against 4P (54F + 16 F3) bytes: 0.16 / 0.31 /
// 0.62 ms.  So each block is bound by its f32 operations but the second and
// third nearly as much by their bytes, and block2's backward by its bytes.
//
// Design: every product of both directions runs on one register-tiled f32
// tile (product_tile; K7 launches it as fwd_product, K8 as bwd_product), the
// weight gradients on its A^T B form (wgrad_slices, then sum_slices).  A CTA
// of 256 threads computes a 128 x 128 or 256 x 64 output tile, a thread 8 x 8
// outputs as two runs of four rows and of four columns (the A^T B form also
// 8 x 4, 4 x 8 and 4 x 4 in tiles 64 or 128 wide).  K (the rows, A^T B) goes
// through shared memory in stages of 16 (kStageK), three in flight, filled
// by cp.async: 16-byte copies where a row stride is a multiple of four
// floats, else 4-byte copies, A of A W stored k-major by a transposing
// 4-byte copy per element, every thread's copy addresses set once.  A thread
// reads a float4 of each operand per four outputs: 16 floats read from
// shared memory feed 64 multiply-adds.  The tile shape comes per product
// from the least of waves x CTAs an SM x tile area over a rate per shape
// (pick), since the widths (F = 258, 129, 64; 2F, 4F, F3) leave ragged
// tiles.  A product's epilogue takes a run of four columns at a time: their
// constants (bias, the residual's channels, the order of dx's gather) once,
// then its rows, with 16-byte loads and stores where the rows allow.  The
// weight gradients' CTAs of the first row of tiles also take the bias
// gradients (column sums of B) in the same order.  Intermediates go through
// device memory between the products: h1, z and z3 forward; the backward
// keeps h1, z, zp (then dz), dzp and dh1p.  Shared memory takes 24-62 KB a
// CTA (115-128 KB with the chunks' sums): two CTAs an SM, one for the 8 x 8
// A^T B tile, whose stage sums take 64 more registers.  What each product
// reaches of the f32 rate: tools/torch_f32_tile_sweep.py (PERF.md, section 6).
//
// No tensor cores: this mode exists for f32 accuracy.  TF32 keeps ~10
// mantissa bits, and a split of each operand into bf16 pieces short of
// three falls short too (kernels/checks.py F32_TRUTH_RATIO refuses both);
// three pieces on the tensor cores are the next lever (ROADMAP Queue 2a).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "phase_stencil.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;      // 8 warps: a 16 x 16 (or 32 x 8) grid on the tile
constexpr int kStageK = 16;        // k (products) or rows (contractions) of a stage
constexpr int kStages = 3;         // stages in flight
constexpr int kSliceRows = 1024;   // rows of one slice of the weight gradients' sums
// A product's K up to kChainK is one chain of fused multiply-adds; a longer
// K is summed in chunks of kChunkK, each a chain from zero, added in order
// (one chain's error grows with K: at K = 3,104 it lay ~3x farther from the
// float64 product than cuBLAS's split sums).  kChainK covers the renderer's
// longest product (4F = 1,032 at F = 258), whose bits stay those of a chain.
constexpr int kChainK = 1040;
constexpr int kChunkK = 128;
constexpr int kTotalFloats = 64 * kThreads;  // the chunks' running sums of a CTA

__device__ __forceinline__ float lrelu(float v) { return v > 0.f ? v : __fmul_rn(0.2f, v); }

// the x channel that group-major z channel k F + c adds: (4c + k) mod F
__device__ __forceinline__ int res_channel(int k, int c, int F) { return (4 * c + k) % F; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 4 bytes from global to shared memory, or zeros (nothing read) when !ok
__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
// 16 bytes, of which the first `bytes` are read and the rest are zeros
__device__ __forceinline__ void copy16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A panel of kStageK rows and kW columns (c0 .. c0 + kW - 1, those below
// cend) of a row-major matrix (row stride ld) to a stage [kStageK][kW],
// zeros past the columns and past the rows' end: 16-byte copies if `vec` (ld
// and the matrix 16-byte aligned), a thread's four columns in kStageK /
// (kThreads / (kW / 4)) rows, else 4-byte copies, a column in kStageK /
// (kThreads / kW) rows.  A thread's column and its pointer are set once.
template <int kW>
struct Panel {
  static_assert(kW <= kThreads, "a thread at least per column");
  static constexpr int kVecStep = kThreads / (kW / 4), kStep = kThreads / kW;
  const float* src;  // the matrix at this thread's column
  size_t ld;
  int col, row, bytes;  // this thread's column and first row; bytes of a copy
  bool vec;

  __device__ __forceinline__ Panel(const float* m, size_t ld_, int c0, int cend, bool vec_)
      : ld(ld_), vec(vec_) {
    if (vec) {
      col = (int)threadIdx.x % (kW / 4) * 4, row = (int)threadIdx.x / (kW / 4);
      const int left = cend - c0 - col;
      bytes = left <= 0 ? 0 : (left >= 4 ? 16 : 4 * left);
    } else {
      col = (int)threadIdx.x % kW, row = (int)threadIdx.x / kW;
      bytes = c0 + col < cend ? 4 : 0;
    }
    src = m + c0 + col;
  }
  // rows r0 .. r0 + kStageK - 1 of the matrix, those below rend
  __device__ __forceinline__ void copy(float* stage, long long r0, long long rend) const {
    if (vec) {
#pragma unroll
      for (int r = 0; r < kStageK; r += kVecStep)
        if (kVecStep <= kStageK || row < kStageK) {
          const long long q = r0 + r + row;
          const int b = q < rend ? bytes : 0;
          copy16(stage + (r + row) * kW + col, b ? src + q * ld : src, b);
        }
    } else {
#pragma unroll
      for (int r = 0; r < kStageK; r += kStep) {
        const long long q = r0 + r + row;
        const bool ok = q < rend && bytes;
        copy4(stage + (r + row) * kW + col, ok ? src + q * ld : src, ok);
      }
    }
  }
};

// The A panel of A W, transposed: A[m0 + m, k0 + k] (row-major, stride lda)
// for m < kBM, k < kStageK to a stage [kStageK][kBM + 4] (k-major), zeros
// past M and K.  Thread t copies k = t % 8 (+ 8) of rows t / 8 + 32 r: a
// warp's copies read 32 bytes of each of four rows, and the padded stride
// puts its 32 writes on 32 banks.
template <int kBM>
struct PanelT {
  static constexpr int kRows = kBM / 32;  // row groups a thread copies
  const float* src;                       // A at row m0 + t / 8, column t % 8
  size_t lda;
  uint32_t live;  // bit r: row m0 + t / 8 + 32 r lies below M
  int tk, tm;

  __device__ __forceinline__ PanelT(const float* A, size_t lda_, long long m0, long long M)
      : lda(lda_), live(0), tk((int)threadIdx.x % 8), tm((int)threadIdx.x / 8) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (m0 + tm + 32 * r < M) live |= 1u << r;
    src = live ? A + (size_t)(m0 + tm) * lda + tk : A;
  }
  __device__ __forceinline__ void copy(float* stage, int k0, int K) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool kin = k0 + tk + 8 * h < K;
      float* d = stage + (tk + 8 * h) * (kBM + 4) + tm;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const bool ok = kin && (live >> r & 1);
        copy4(d + 32 * r, ok ? src + (size_t)(32 * r) * lda + k0 + 8 * h : src, ok);
      }
    }
  }
};

// acc[i][j] = fma(a[i], b[j], acc[i][j]) for a thread's TM rows and TN
// columns of one k: its rows are TM / 4 runs of four, 4 kBM / TM apart, from
// row 4 ty (the columns likewise from 4 tx); `a` and `b` point at k's row of
// the two stages.
template <int kBM, int kBN, int TM, int TN>
__device__ __forceinline__ void fma_step(const float* a, const float* b, int ty, int tx,
                                         float (&acc)[TM][TN]) {
  float av[TM], bv[TN];
#pragma unroll
  for (int c = 0; c < TM / 4; ++c) {
    const float4 v = *reinterpret_cast<const float4*>(a + c * (4 * kBM / TM) + 4 * ty);
    av[4 * c] = v.x, av[4 * c + 1] = v.y, av[4 * c + 2] = v.z, av[4 * c + 3] = v.w;
  }
#pragma unroll
  for (int c = 0; c < TN / 4; ++c) {
    const float4 v = *reinterpret_cast<const float4*>(b + c * (4 * kBN / TN) + 4 * tx);
    bv[4 * c] = v.x, bv[4 * c + 1] = v.y, bv[4 * c + 2] = v.z, bv[4 * c + 3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
}

// ---------------------------------------------------------------------------
// the products out[M, N] = epilogue(A W): A [M, K] (row stride lda), W [K, N]
// (row stride ldw)

enum Epilogue {
  kPlain,  // out = acc
  kH1,     // out = lrelu(acc + bias)
  kZ,      // zp = acc + bias; out = lrelu(zp) + aux[m, res_channel] (aux: x [M, F]); out2 = zp
  kZ3,     // out = acc + bias
  kDz,     // dz = acc: out = lrelu'(out2) dz (out2: zp), then out2 = dz
  kDh1,    // out = lrelu'(aux) acc (aux: h1)
  kDx,     // out = acc + the residual's adjoint of aux (dz [M, 4F])
};

struct Prod {
  const float* a;
  const float* w;
  long long M;
  int N, K, lda, ldw, vec_w;
  int mode;           // Epilogue
  int vec_o;          // rows of out, out2 and aux (kDz, kDh1) 16-byte aligned
  float* out;         // [M, N]
  float* out2;        // [M, N] (kZ, where not null; kDz)
  const float* bias;  // [N]
  const float* aux;
  int F;
};

// Four consecutive floats at p (`valid` of them inside the row), as one
// 16-byte access where `vec`
__device__ __forceinline__ void load4(float (&v)[4], const float* p, int valid, bool vec) {
  if (vec && valid == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = j < valid ? p[j] : 0.f;
  }
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4], int valid, bool vec) {
  if (vec && valid == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < valid) p[j] = v[j];
  }
}

// The channels of dz [*, 4F] that x channel n gathers (4c + k = n + jF, j
// = 0..3), as offsets k F + c in a row, in the order the residual's adjoint
// sums them: increasing k, then j (a sorting network of five exchanges)
__device__ __forceinline__ void gather_order(int n, int F, int (&off)[4]) {
  int key[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = n + j * F;
    key[j] = (q & 3) << 2 | j;
    off[j] = (q & 3) * F + (q >> 2);
  }
  auto cx = [&](int a, int b) {
    if (key[a] > key[b]) {
      const int k = key[a], o = off[a];
      key[a] = key[b], off[a] = off[b], key[b] = k, off[b] = o;
    }
  };
  cx(0, 1), cx(2, 3), cx(0, 2), cx(1, 3), cx(1, 2);
}

// The epilogue of one run of four columns n .. n + 3 (`valid` of them below
// N): rows(f) calls f(m, acc) for each of the thread's rows m below M with
// its four accumulators.  Per mode the columns' constants first, then the
// rows; each output rounds as the plain version does.
template <class Rows>
__device__ __forceinline__ void epilogue_run(const Prod& p, int n, int valid, Rows&& rows) {
  const bool vec = p.vec_o;
  float b[4];
  if (p.bias)
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = j < valid ? p.bias[n + j] : 0.f;
  switch (p.mode) {
    case kPlain:
      rows([&](long long m, const float* acc) {
        const float v[4] = {acc[0], acc[1], acc[2], acc[3]};
        store4(p.out + (size_t)m * p.N + n, v, valid, vec);
      });
      break;
    case kH1:
    case kZ3:
      rows([&](long long m, const float* acc) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = __fadd_rn(acc[j], b[j]);
          if (p.mode == kH1) v[j] = lrelu(v[j]);
        }
        store4(p.out + (size_t)m * p.N + n, v, valid, vec);
      });
      break;
    case kZ: {
      int rc[4];  // the x channel each column's residual adds
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = (n + j) / p.F;
        rc[j] = res_channel(k, n + j - k * p.F, p.F);
      }
      rows([&](long long m, const float* acc) {
        const float* x = p.aux + (size_t)m * p.F;
        float z[4], zp[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          zp[j] = __fadd_rn(acc[j], b[j]);
          z[j] = j < valid ? __fadd_rn(lrelu(zp[j]), x[rc[j]]) : 0.f;
        }
        store4(p.out + (size_t)m * p.N + n, z, valid, vec);
        if (p.out2) store4(p.out2 + (size_t)m * p.N + n, zp, valid, vec);
      });
      break;
    }
    case kDz:
      rows([&](long long m, const float* acc) {
        const size_t o = (size_t)m * p.N + n;
        float zp[4], g[4];
        const float d[4] = {acc[0], acc[1], acc[2], acc[3]};
        load4(zp, p.out2 + o, valid, vec);
#pragma unroll
        for (int j = 0; j < 4; ++j) g[j] = zp[j] > 0.f ? d[j] : __fmul_rn(0.2f, d[j]);
        store4(p.out + o, g, valid, vec);
        store4(p.out2 + o, d, valid, vec);
      });
      break;
    case kDh1:
      rows([&](long long m, const float* acc) {
        const size_t o = (size_t)m * p.N + n;
        float h[4], g[4];
        load4(h, p.aux + o, valid, vec);
#pragma unroll
        for (int j = 0; j < 4; ++j) g[j] = h[j] > 0.f ? acc[j] : __fmul_rn(0.2f, acc[j]);
        store4(p.out + o, g, valid, vec);
      });
      break;
    case kDx: {
      int off[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) gather_order(n + j, p.F, off[j]);
      rows([&](long long m, const float* acc) {
        const float* dz = p.aux + (size_t)m * 4 * p.F;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float s = 0.f;
          if (j < valid)
#pragma unroll
            for (int t = 0; t < 4; ++t) s = __fadd_rn(s, dz[off[j][t]]);
          v[j] = __fadd_rn(acc[j], s);
        }
        store4(p.out + (size_t)m * p.N + n, v, valid, vec);
      });
      break;
    }
  }
}

// One kBM x kBN tile of A W, a thread 8 x 8 outputs: tile t of the grid is
// row tile t / (column tiles), column tile t mod (column tiles), so the
// tiles that share A's rows run side by side.  kChunked: K in chunks of
// kChunkK (K > kChainK), the chunks' running sum in shared memory
// (kTotalFloats more, a thread's 64 floats kThreads apart).
template <int kBM, int kBN, bool kChunked>
__device__ __forceinline__ void product_tile(const Prod& p) {
  constexpr int TM = 8, TN = 8, TX = kBN / TN, kAS = kBM + 4;
  static_assert((kBM / TM) * TX == kThreads, "a thread per 8 x 8 outputs");
  extern __shared__ __align__(16) float tile_smem[];
  float* sa = tile_smem;                              // [kStages][kStageK][kAS], k-major
  float* sw = tile_smem + kStages * kStageK * kAS;    // [kStages][kStageK][kBN]
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
  const int col_tiles = (p.N + kBN - 1) / kBN;
  const long long m0 = (long long)(blockIdx.x / col_tiles) * kBM;
  const int n0 = (int)(blockIdx.x % col_tiles) * kBN;
  const int nk = (p.K + kStageK - 1) / kStageK;
  const PanelT<kBM> pa(p.a, p.lda, m0, p.M);
  const Panel<kBN> pw(p.w, p.ldw, n0, p.N, p.vec_w);
  auto load = [&](int kt) {
    const int s = kt % kStages, k0 = kt * kStageK;
    pa.copy(sa + s * kStageK * kAS, k0, p.K);
    pw.copy(sw + s * kStageK * kBN, k0, p.K);
  };
  float* total = sw + kStages * kStageK * kBN;  // kChunked: [TM * TN][kThreads]
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s);
    copy_commit();
  }
  constexpr int kChunkStages = kChunkK / kStageK;
  for (int kt = 0; kt < nk; ++kt) {
    copy_wait<kStages - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();           // ... and every thread's; stage kt - 1 is free
    if (kt + kStages - 1 < nk) load(kt + kStages - 1);
    copy_commit();
    const float* a = sa + (kt % kStages) * kStageK * kAS;
    const float* w = sw + (kt % kStages) * kStageK * kBN;
    const int kv = p.K - kt * kStageK;
    if (kv >= kStageK) {
#pragma unroll
      for (int k = 0; k < kStageK; ++k)
        fma_step<kBM, kBN, TM, TN>(a + k * kAS, w + k * kBN, ty, tx, acc);
    } else {
      for (int k = 0; k < kv; ++k)  // the K tail: bounded by the loop, no zero terms
        fma_step<kBM, kBN, TM, TN>(a + k * kAS, w + k * kBN, ty, tx, acc);
    }
    if constexpr (kChunked) {
      if ((kt + 1) % kChunkStages == 0 || kt == nk - 1) {  // a chunk ends
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            float* t = total + (i * TN + j) * kThreads + threadIdx.x;
            const float v = kt < kChunkStages ? acc[i][j] : __fadd_rn(*t, acc[i][j]);
            if (kt == nk - 1) {
              acc[i][j] = v;
            } else {
              *t = v;
              acc[i][j] = 0.f;
            }
          }
      }
    }
  }
  copy_wait<0>();
  // the thread's two runs of four columns, each over its eight rows
#pragma unroll
  for (int c = 0; c < TN / 4; ++c) {
    const int n = n0 + c * (4 * kBN / TN) + 4 * tx;
    if (n >= p.N) continue;
    epilogue_run(p, n, p.N - n < 4 ? p.N - n : 4, [&](auto&& f) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const long long m = m0 + (i / 4) * (4 * kBM / TM) + 4 * ty + i % 4;
        if (m < p.M) f(m, &acc[i][4 * c]);
      }
    });
  }
}

// K7's and K8's products: one tile, two names, so that a profile of a
// training step gives each kernel its own time
template <int kBM, int kBN, bool kChunked>
__global__ void __launch_bounds__(kThreads, 2) fwd_product(const Prod p) {
  product_tile<kBM, kBN, kChunked>(p);
}
template <int kBM, int kBN, bool kChunked>
__global__ void __launch_bounds__(kThreads, 2) bwd_product(const Prod p) {
  product_tile<kBM, kBN, kChunked>(p);
}

// ---------------------------------------------------------------------------
// the weight gradients: dW [M, N] = A^T B and db [N] = the column sums of B,
// A [rows, M] and B [rows, N] row-major

struct Contract {
  const float* a;
  const float* b;
  long long rows;
  int M, N, vec_a, vec_b;
  float* part;  // [slices][M N + N]: a slice's dW, then its db
};

// One kBM x kBN tile of dW over one slice of rows (a thread TM x TN
// outputs): per stage of kStageK rows the products summed from zero, then
// added to the slice's sum.  The tiles of the first row also take db's
// columns (a thread each) in the same order.  Grid: slice-major, then row
// tile, then column tile.
template <int kBM, int kBN, int TM, int TN, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks) wgrad_slices(const Contract p) {
  constexpr int TX = kBN / TN;
  static_assert((kBM / TM) * TX == kThreads, "a thread per TM x TN outputs");
  extern __shared__ __align__(16) float tile_smem[];
  float* sa = tile_smem;                            // [kStages][kStageK][kBM]
  float* sb = tile_smem + kStages * kStageK * kBM;  // [kStages][kStageK][kBN]
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
  const int col_tiles = (p.N + kBN - 1) / kBN, row_tiles = (p.M + kBM - 1) / kBM;
  const int tile = blockIdx.x % (col_tiles * row_tiles), slice = blockIdx.x / (col_tiles * row_tiles);
  const int m0 = tile / col_tiles * kBM, n0 = tile % col_tiles * kBN;
  const long long r_begin = (long long)slice * kSliceRows;
  const long long r_end = p.rows < r_begin + kSliceRows ? p.rows : r_begin + kSliceRows;
  const int ns = (int)((r_end - r_begin + kStageK - 1) / kStageK);
  const bool bias = m0 == 0 && threadIdx.x < kBN;
  const Panel<kBM> pa(p.a, p.M, m0, p.M, p.vec_a);
  const Panel<kBN> pb(p.b, p.N, n0, p.N, p.vec_b);
  auto load = [&](int s) {
    const int slot = s % kStages;
    const long long r0 = r_begin + (long long)s * kStageK;
    pa.copy(sa + slot * kStageK * kBM, r0, r_end);
    pb.copy(sb + slot * kStageK * kBN, r0, r_end);
  };
  float acc[TM][TN], dbacc = 0.f;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ns) load(s);
    copy_commit();
  }
  for (int s = 0; s < ns; ++s) {
    copy_wait<kStages - 2>();
    __syncthreads();
    if (s + kStages - 1 < ns) load(s + kStages - 1);
    copy_commit();
    const float* a = sa + (s % kStages) * kStageK * kBM;
    const float* b = sb + (s % kStages) * kStageK * kBN;
    // rows past the slice are zeros in both stages: fma(0, 0, v) = v
    float stage[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) stage[i][j] = 0.f;
#pragma unroll
    for (int r = 0; r < kStageK; ++r)
      fma_step<kBM, kBN, TM, TN>(a + r * kBM, b + r * kBN, ty, tx, stage);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = __fadd_rn(acc[i][j], stage[i][j]);
    if (bias) {
      float st = 0.f;
#pragma unroll
      for (int r = 0; r < kStageK; ++r) st = __fadd_rn(st, b[r * kBN + threadIdx.x]);
      dbacc = __fadd_rn(dbacc, st);
    }
  }
  copy_wait<0>();
  float* out = p.part + (size_t)slice * ((size_t)p.M * p.N + p.N);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i / 4) * (4 * kBM / TM) + 4 * ty + i % 4;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + (j / 4) * (4 * kBN / TN) + 4 * tx + j % 4;
      if (n < p.N) out[(size_t)m * p.N + n] = acc[i][j];
    }
  }
  if (bias && n0 + (int)threadIdx.x < p.N) out[(size_t)p.M * p.N + n0 + threadIdx.x] = dbacc;
}

// out[i] (i < split; else out2[i - split]) = the pairwise sum over s of
// part[s, i]: slice s joins the sums of the slices before it as in a binary
// counter (s = ..., 4 + 5 + 6 + 7, ...).  An aligned group of 16 slices is
// one subtree of that counter: its 16 loads go out together, its tree is
// summed, and it joins the stack as slice group g does (carries by g's bits).
__global__ void sum_slices(const float* part, int slices, int len, int split, float* out,
                           float* out2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float stack[32];
  int top = 0;
  const int groups = slices / 16;
  for (int g = 0; g < groups; ++g) {
    float v[16];
#pragma unroll
    for (int s = 0; s < 16; ++s) v[s] = part[(size_t)(16 * g + s) * len + i];
#pragma unroll
    for (int w = 1; w < 16; w *= 2)
#pragma unroll
      for (int s = 0; s < 16; s += 2 * w) v[s] = v[s] + v[s + w];
    float x = v[0];
    for (int t = g; t & 1; t >>= 1) x = stack[--top] + x;
    stack[top++] = x;
  }
  for (int s = 16 * groups; s < slices; ++s) {
    float v = part[(size_t)s * len + i];
    for (int t = s; t & 1; t >>= 1) v = stack[--top] + v;
    stack[top++] = v;
  }
  float v = stack[--top];
  while (top) v = stack[--top] + v;
  if (i < split)
    out[i] = v;
  else
    out2[i - split] = v;
}

// ---------------------------------------------------------------------------
// host side

// A tile shape: rows, columns, CTAs an SM (by registers and shared memory)
// and a rate relative to the widest tile's (the narrower tiles read more
// of shared memory, or of L2, per multiply-add)
struct Shape {
  int bm, bn, per_sm;
  double rate;
};
// the products: 8 x 8 outputs a thread
constexpr Shape kProducts[] = {{128, 128, 2, 1.0}, {256, 64, 2, 0.9}};
// the weight gradients: 8 x 8, 8 x 4, 4 x 8 and 4 x 4 outputs a thread
constexpr Shape kContracts[] = {{128, 128, 1, 1.0}, {128, 64, 2, 0.9}, {64, 128, 2, 0.9},
                                {64, 64, 3, 0.9}};
constexpr int kNumProducts = sizeof(kProducts) / sizeof(Shape);
constexpr int kNumContracts = sizeof(kContracts) / sizeof(Shape);

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// The shape of least estimated time for an M x N output in `z` parts:
// waves of CTAs x CTAs an SM x tile area / rate
int pick(const Shape* s, int n, long long M, long long N, long long z) {
  const long long sms = sm_count();
  int best = 0;
  double best_cost = 0;
  for (int i = 0; i < n; ++i) {
    const long long ctas = (M + s[i].bm - 1) / s[i].bm * ((N + s[i].bn - 1) / s[i].bn) * z;
    const long long slots = sms * s[i].per_sm;
    const double cost = (double)((ctas + slots - 1) / slots) * s[i].per_sm * s[i].bm * s[i].bn /
                        s[i].rate;
    if (i == 0 || cost < best_cost) best = i, best_cost = cost;
  }
  return best;
}

template <int kBM, int kBN>
cudaError_t launch_product_as(bool bwd, const Prod& p, cudaStream_t st) {
  const bool chunked = p.K > kChainK;
  auto k = bwd ? (chunked ? bwd_product<kBM, kBN, true> : bwd_product<kBM, kBN, false>)
               : (chunked ? fwd_product<kBM, kBN, true> : fwd_product<kBM, kBN, false>);
  const int smem = (kStages * kStageK * (kBM + 4 + kBN) + (chunked ? kTotalFloats : 0)) *
                   (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (p.M + kBM - 1) / kBM * ((p.N + kBN - 1) / kBN);
  if (tiles >= (1LL << 31)) return cudaErrorInvalidValue;
  k<<<(unsigned)tiles, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

// Launch one product in the tile shape `shape` (< 0: pick's)
cudaError_t launch_product(bool bwd, Prod p, int shape, cudaStream_t st) {
  if (p.M <= 0 || p.N <= 0 || p.K <= 0) return cudaErrorInvalidValue;
  auto aligned = [](const void* q) { return (uintptr_t)q % 16 == 0; };
  p.vec_w = p.ldw % 4 == 0 && aligned(p.w);
  p.vec_o = p.N % 4 == 0 && aligned(p.out) && aligned(p.out2) &&
            (aligned(p.aux) || (p.mode != kDz && p.mode != kDh1));
  if (shape < 0) shape = pick(kProducts, kNumProducts, p.M, p.N, 1);
  switch (shape) {
    case 0: return launch_product_as<128, 128>(bwd, p, st);
    case 1: return launch_product_as<256, 64>(bwd, p, st);
  }
  return cudaErrorInvalidValue;
}

Prod product(const float* a, int lda, const float* w, int ldw, long long M, int N, int K,
             Epilogue mode, float* out) {
  Prod p{};
  p.a = a, p.lda = lda, p.w = w, p.ldw = ldw, p.M = M, p.N = N, p.K = K;
  p.mode = mode, p.out = out;
  return p;
}

long long slices_of(long long rows) { return (rows + kSliceRows - 1) / kSliceRows; }

// Floats of the weight gradients' partial sums for rows x [M, N]
long long part_floats(long long rows, int M, int N) {
  return slices_of(rows) * ((long long)M * N + N);
}

template <int kBM, int kBN, int TM, int TN, int kMinBlocks>
cudaError_t launch_contract_as(const Contract& p, long long slices, cudaStream_t st) {
  auto k = wgrad_slices<kBM, kBN, TM, TN, kMinBlocks>;
  const int smem = kStages * kStageK * (kBM + kBN) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long ctas = (long long)((p.M + kBM - 1) / kBM) * ((p.N + kBN - 1) / kBN) * slices;
  if (ctas >= (1LL << 31)) return cudaErrorInvalidValue;
  k<<<(unsigned)ctas, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

// dW = A^T B to dw [M, N] and db = the column sums of B to db [N], through
// the partial sums `part` (part_floats), in the tile shape `shape` (< 0:
// pick's)
cudaError_t contract(const float* A, const float* B, long long rows, int M, int N, float* part,
                     float* dw, float* db, int shape, cudaStream_t st) {
  if (rows <= 0 || M <= 0 || N <= 0) return cudaErrorInvalidValue;
  const long long slices = slices_of(rows);
  Contract p{A, B, rows, M, N, M % 4 == 0 && (uintptr_t)A % 16 == 0,
             N % 4 == 0 && (uintptr_t)B % 16 == 0, part};
  if (shape < 0) shape = pick(kContracts, kNumContracts, M, N, slices);
  cudaError_t err = cudaErrorInvalidValue;
  switch (shape) {
    case 0: err = launch_contract_as<128, 128, 8, 8, 1>(p, slices, st); break;
    case 1: err = launch_contract_as<128, 64, 8, 4, 2>(p, slices, st); break;
    case 2: err = launch_contract_as<64, 128, 4, 8, 2>(p, slices, st); break;
    case 3: err = launch_contract_as<64, 64, 4, 4, 3>(p, slices, st); break;
  }
  if (err != cudaSuccess) return err;
  const long long len = (long long)M * N + N;
  if (len >= (1LL << 31)) return cudaErrorInvalidValue;
  sum_slices<<<(unsigned)((len + 255) / 256), 256, 0, st>>>(part, (int)slices, (int)len, M * N,
                                                            dw, db);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of the scratch for P pixels.  Forward (bwd = 0): h1 [P, 2F], z
// [P, 4F], z3 [P, 4 F3].  Backward: dz3 [P, 4 F3], h1 [P, 2F], z [P, 4F],
// zp (then dz) [P, 4F], dzp [P, 4F], dh1p [P, 2F], then the weight
// gradients' partial sums (the largest of the three).
long long fused_upsampler_f32_scratch(long long P, int F, int F3, int bwd) {
  if (!bwd) return P * (6LL * F + 4LL * F3);
  long long part = part_floats(P, F, 2 * F);
  const long long p2 = part_floats(P, 2 * F, 4 * F), p3 = part_floats(4 * P, F, F3);
  part = part > p2 ? part : p2;
  part = part > p3 ? part : p3;
  return P * (4LL * F3 + 16LL * F) + part;
}

// K7 at f32 on `stream`: x [P = B*H*W, F] f32 and f32 weights ([in, out],
// W2g's columns group-major) -> h1, z, z3 in `scratch` -> y [B, 2H, 2W, F3]
// (bf16 if y_bf16, else f32).  Returns the first cudaError_t (0 = success).
int fused_upsampler_f32_fwd(const float* x, const float* w1, const float* b1, const float* w2,
                            const float* b2, const float* w3, const float* b3, float* scratch,
                            void* y, int B, int H, int W, int F, int F3, int y_bf16,
                            void* stream) {
  const long long P = (long long)B * H * W;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* h1 = scratch;
  float* z = h1 + P * 2 * F;
  float* z3 = z + P * 4 * F;
  Prod p = product(x, F, w1, 2 * F, P, 2 * F, F, kH1, h1);
  p.bias = b1;
  cudaError_t err = launch_product(false, p, -1, st);
  if (err != cudaSuccess) return (int)err;
  p = product(h1, 2 * F, w2, 4 * F, P, 4 * F, 2 * F, kZ, z);
  p.bias = b2, p.aux = x, p.F = F;
  if ((err = launch_product(false, p, -1, st)) != cudaSuccess) return (int)err;
  // the phases' rows: z [P, 4F] read as [4P, F], z3 [P, 4 F3] as [4P, F3]
  p = product(z, F, w3, F3, 4 * P, F3, F, kZ3, z3);
  p.bias = b3;
  if ((err = launch_product(false, p, -1, st)) != cudaSuccess) return (int)err;
  return y_bf16 ? stencil::launch_fwd<float, bf16>(z3, y, B, H, W, F3, st)
                : stencil::launch_fwd<float, float>(z3, y, B, H, W, F3, st);
}

// K8 at f32 on `stream`: dy [B, 2H, 2W, F3] f32 -> dx [P, F] f32 and the
// weight gradients dW1 [F, 2F], db1 [2F], dW2g [2F, 4F], db2g [4F], dW3
// [F, F3], db3 [F3].  w3t, w2t, w1t are W3^T [F3, F], W2g^T [4F, 2F], W1^T
// [2F, F]; scratch holds fused_upsampler_f32_scratch(P, F, F3, 1) floats.
int fused_upsampler_f32_bwd(const float* x, const float* dy, const float* w1, const float* b1,
                            const float* w2, const float* b2, const float* w3t,
                            const float* w2t, const float* w1t, float* dx, float* dw1,
                            float* db1, float* dw2, float* db2, float* dw3, float* db3,
                            float* scratch, int B, int H, int W, int F, int F3, void* stream) {
  const long long P = (long long)B * H * W;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dz3 = scratch;
  float* h1 = dz3 + P * 4 * F3;
  float* z = h1 + P * 2 * F;
  float* dz = z + P * 4 * F;  // zp until the dz product
  float* dzp = dz + P * 4 * F;
  float* dh1p = dzp + P * 4 * F;
  float* part = dh1p + P * 2 * F;
  int e = stencil::launch_bwd<float, float>(dy, dz3, B, H, W, F3, st);
  if (e) return e;
  // the chain's recompute: h1; zp and z
  Prod p = product(x, F, w1, 2 * F, P, 2 * F, F, kH1, h1);
  p.bias = b1;
  cudaError_t err = launch_product(true, p, -1, st);
  if (err != cudaSuccess) return (int)err;
  p = product(h1, 2 * F, w2, 4 * F, P, 4 * F, 2 * F, kZ, z);
  p.bias = b2, p.aux = x, p.F = F, p.out2 = dz;
  if ((err = launch_product(true, p, -1, st)) != cudaSuccess) return (int)err;
  // dz_k = dz3_k W3^T on the phases' rows, dzp = lrelu'(zp) dz
  p = product(dz3, F3, w3t, F, 4 * P, F, F3, kDz, dzp);
  p.out2 = dz;
  if ((err = launch_product(true, p, -1, st)) != cudaSuccess) return (int)err;
  // dh1p = lrelu'(h1p) (dzp W2g^T) (h1 > 0 iff h1p > 0)
  p = product(dzp, 4 * F, w2t, 2 * F, P, 2 * F, 4 * F, kDh1, dh1p);
  p.aux = h1;
  if ((err = launch_product(true, p, -1, st)) != cudaSuccess) return (int)err;
  // dx = dh1p W1^T + the residual's part
  p = product(dh1p, 2 * F, w1t, F, P, F, 2 * F, kDx, dx);
  p.aux = dz, p.F = F;
  if ((err = launch_product(true, p, -1, st)) != cudaSuccess) return (int)err;
  if ((err = contract(x, dh1p, P, F, 2 * F, part, dw1, db1, -1, st)) != cudaSuccess)
    return (int)err;
  if ((err = contract(h1, dzp, P, 2 * F, 4 * F, part, dw2, db2, -1, st)) != cudaSuccess)
    return (int)err;
  return (int)contract(z, dz3, 4 * P, F, F3, part, dw3, db3, -1, st);
}

// The number of tile shapes of the products (contract = 0) or of the
// weight gradients (contract = 1)
int fused_upsampler_f32_shapes(int contract) { return contract ? kNumContracts : kNumProducts; }

// The product tile alone: out [M, N] = a [M, K] (row stride lda) w [K, N]
// (row stride ldw), every output a chain of fused multiply-adds in
// increasing k from zero (past kChainK, chunks of kChunkK added in order),
// in tile shape `shape` (< 0: the one K7 and K8 would pick).
int fused_upsampler_f32_product(const float* a, int lda, const float* w, int ldw, float* out,
                                long long M, int N, int K, int shape, void* stream) {
  return (int)launch_product(true, product(a, lda, w, ldw, M, N, K, kPlain, out), shape,
                             static_cast<cudaStream_t>(stream));
}

// Floats of the partial sums of fused_upsampler_f32_contract
long long fused_upsampler_f32_part(long long rows, int M, int N) {
  return part_floats(rows, M, N);
}

// The weight gradients' contraction alone: dw [M, N] = a^T b and db [N] =
// the column sums of b, a [rows, M] and b [rows, N], in K8's order, in tile
// shape `shape` (< 0: the one K8 would pick).
int fused_upsampler_f32_contract(const float* a, const float* b, long long rows, int M, int N,
                                 float* part, float* dw, float* db, int shape, void* stream) {
  return (int)contract(a, b, rows, M, N, part, dw, db, shape, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
