// The renderer's blur-shuffle stencil, blur3x3(pixel_shuffle2(x)), on a
// group-major [B, H, W, 4C] input (channel k*C + c is shuffle phase k of
// channel c), and its adjoint.  Shared by csrc/shuffle_blur.cu (K5 / K6) and
// the fused upsampler's two kernels, which run it on their f32 scratch.
//
// Numerics: the taps (1, 2, 1)/4 x (1, 2, 1)/4 are powers of two, so every
// tap product is exact and a fused multiply-add rounds like a product and a
// sum; the sums run in f32 in the order of the plain versions in
// kernels/shuffle_blur.py, and the result is rounded once to the output type.
// The kernel and its plain version give the same bits.
//
// Design (both directions).  The stencil reads each input pixel for two
// rows of outputs and two columns, so a CTA takes a strip of columns and a
// run of rows and walks down the rows with the rows it needs in a
// shared-memory ring: K5 keeps input rows h - 1, h, h + 1 for output rows 2h
// and 2h + 1, K6 keeps dy rows 2h - 1 .. 2h + 2 (pairs h - 1, h, h + 1) for
// dx row h, and one more row is in flight while a row is computed.  Each
// step copies one row of the strip (its one-pixel halo included, clamped at
// the image's edge) with 16-byte cp.async, so every input byte is read from
// device memory about once; the halo's and the runs' boundary rows come
// again from L2.  A row segment is contiguous in memory (pixels x channels):
// it lands in shared memory at the same address modulo 16 as in device
// memory, which keeps 16-byte copies whatever the pixel's width (1032 bytes
// for K5's C = 129 in bf16, 258 for K6's); narrow pixels are instead copied
// one by one to a padded stride that spreads a warp's reads over the banks.
// A thread takes a pixel and V consecutive channels (V = 8 in bf16 and 4 in
// f32 where C and the pointers allow, down to 1): K5 reads the 4 x 4
// neighbourhood of phase blocks its four outputs (2 x 2 shuffled positions)
// share, 4 vector reads per output where one output alone needs 9, and K6
// the 4 x 4 dy values of its four phases; each stores four V-vectors.  The
// per-pixel index arithmetic is done once per item, not per element.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stencil {

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

// The adjoint along one axis of length L: position M of the shuffled image
// receives 0.5 of output M and 0.25 of outputs M - 1 and M + 1 that exist,
// plus the reflected taps: output 0 reads M = 1 (so M = 1 takes 0.5 of
// output 0) and output L - 1 reads M = L - 2.
__device__ __forceinline__ float w_prev(int M) { return M == 1 ? 0.5f : 0.25f; }
__device__ __forceinline__ float w_next(int M, int L) { return M == L - 2 ? 0.5f : 0.25f; }
// the same with the missing neighbour's weight 0, as the plain version has it
__device__ __forceinline__ float w_prev0(int M) { return M == 0 ? 0.f : w_prev(M); }
__device__ __forceinline__ float w_next0(int M, int L) { return M == L - 1 ? 0.f : w_next(M, L); }

// The adjoint of the forward at element (b, h, w, k*C + c) of its [B, H, W,
// 4C] input, from dy [B, 2H, 2W, C]: shuffled position (M, N) = (2h + k/2,
// 2w + k%2), separable: each of the (up to) three rows of dy is summed over
// its (up to) three columns first, in order.  One element, for the fused
// upsampler's backward.
template <typename Tin>
__device__ __forceinline__ float adjoint_at(const Tin* __restrict__ dy, int b, int h, int w,
                                            int k, int c, int H, int W, int C) {
  const int L = 2 * H, Lc = 2 * W;
  const int M = 2 * h + (k >> 1), N = 2 * w + (k & 1);
  const Tin* db = dy + (size_t)b * L * Lc * C + c;
  float acc = 0.f;
#pragma unroll
  for (int dm = -1; dm <= 1; ++dm) {
    const int p = M + dm;
    if (p < 0 || p >= L) continue;
    const Tin* row = db + (size_t)p * Lc * C;
    float rs = 0.f;
    if (N >= 1) rs += w_prev(N) * load_f(row + (size_t)(N - 1) * C);
    rs += 0.5f * load_f(row + (size_t)N * C);
    if (N + 1 < Lc) rs += w_next(N, Lc) * load_f(row + (size_t)(N + 1) * C);
    acc += (dm < 0 ? w_prev(M) : dm > 0 ? w_next(M, L) : 0.5f) * rs;
  }
  return acc;
}

// ---------------------------------------------------------------------------
// K5 and K6: strips of columns walking down their rows

constexpr int kRing = 4;          // row slots: h - 1, h, h + 1 and one in flight
// threads a CTA may have: a thread of one channel (V = 1, at an odd C) holds
// ~40 registers, so a row of a strip fits in one pass of a CTA's threads
template <int V>
constexpr int kMaxThreads = V == 1 ? 1024 : 512;
constexpr int kSlack = 16;        // bytes before a plane's data (see plane_base)

// A launch's geometry, the same for every CTA (the host's plan()).  "Pixel"
// is a pixel of the stencil's input: of x [B, H, W, 4C] for K5 (4C channels),
// of dy [B, 2H, 2W, C] for K6 (C channels).  A slot holds one row of the
// strip (K5) or the pair of dy rows 2t, 2t + 1 (K6), one plane each.
struct Strip {
  int H, W, C;     // x / dx is [B, H, W, 4C]
  int sw, rh;      // x / dx pixels per strip, rows per CTA
  int groups;      // C / V: a pixel's channel groups
  int items;       // sw * groups: (pixel, group) items per row
  int npix;        // pixels a plane holds: sw + 2 (K5), 2 sw + 2 (K6)
  int pb;          // bytes of a pixel in device memory
  int ps;          // bytes between pixels in shared memory: pb, or pb padded
  int plane;       // bytes between planes (a multiple of 16)
  int slot;        // bytes between slots
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where a plane's pixel 0 lies in shared memory, for a run of pixels whose
// first, pixel p0 of the plane, starts at `src` in device memory: unpadded
// (ps == pb) the data keeps its address modulo 16, padded (src 16-byte
// aligned, the host checks) at the plane's start plus the slack.
__device__ __forceinline__ char* plane_base(char* plane, const char* src, int p0,
                                           const Strip& s) {
  if (s.ps != s.pb) return plane + kSlack;
  const int sh = (int)(((uintptr_t)src & 15) - (uintptr_t)p0 * s.pb) & 15;
  return plane + kSlack + sh;
}

// Copy n pixels, contiguous at src, to pixels p0 .. p0 + n - 1 of the plane
// whose pixel 0 is at `base`, with 16-byte cp.async by every thread.
__device__ __forceinline__ void copy_run(char* base, const char* src, int p0, int n,
                                         const Strip& s) {
  if (s.ps == s.pb) {
    // the run's bytes as a whole, from src rounded down to 16 bytes
    const int lead = (int)((uintptr_t)src & 15);
    const char* g = src - lead;
    char* d = base + p0 * s.pb - lead;
    const int nch = (lead + n * s.pb + 15) >> 4;
    for (int i = threadIdx.x; i < nch; i += blockDim.x) cp16(d + 16 * i, g + 16 * i);
  } else {
    // pixel by pixel to the padded stride
    const int per = s.pb >> 4;
    const int nch = n * per;
    int p = threadIdx.x / per, q = threadIdx.x - p * per;
    const int dp = blockDim.x / per, dq = blockDim.x - dp * per;
    for (int i = threadIdx.x; i < nch; i += blockDim.x) {
      cp16(base + (p0 + p) * s.ps + 16 * q, src + p * s.pb + 16 * q);
      p += dp;
      q += dq;
      if (q >= per) {
        q -= per;
        ++p;
      }
    }
  }
}

// V consecutive values of a shared-memory vector, as f32
template <int V>
__device__ __forceinline__ void load_vec(const char* p, float (&v)[V], const float*) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = *reinterpret_cast<const float*>(p);
  }
}
template <int V>
__device__ __forceinline__ void load_vec(const char* p, float (&v)[V], const __nv_bfloat16*) {
  if constexpr (V == 1) {
    v[0] = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
  } else {
    uint32_t w[V / 2];
    if constexpr (V == 8) {
      const uint4 t = *reinterpret_cast<const uint4*>(p);
      w[0] = t.x, w[1] = t.y, w[2] = t.z, w[3] = t.w;
    } else if constexpr (V == 4) {
      const uint2 t = *reinterpret_cast<const uint2*>(p);
      w[0] = t.x, w[1] = t.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {  // a bf16's bits are the high half of its f32
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// V values stored to device memory, rounded once to the output type
template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}
template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[V]) {
  if constexpr (V == 1) {
    *p = __float2bfloat16_rn(v[0]);
  } else {
    uint32_t w[V / 2];
#pragma unroll
    for (int i = 0; i < V / 2; ++i)
      w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])) |
             (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1])) << 16;
    if constexpr (V == 8) {
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (V == 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<uint32_t*>(p) = w[0];
    }
  }
}

// A thread's first item (pixel, channel group) and its step between items
// (blockDim.x items), so that items advance without a division.
struct Items {
  int wl, g, dwl, dg;
};
__device__ __forceinline__ Items first_item(const Strip& s) {
  Items it;
  it.wl = threadIdx.x / s.groups;
  it.g = threadIdx.x - it.wl * s.groups;
  it.dwl = blockDim.x / s.groups;
  it.dg = blockDim.x - it.dwl * s.groups;
  return it;
}
__device__ __forceinline__ void next_item(Items& it, const Strip& s) {
  it.wl += it.dwl;
  it.g += it.dg;
  if (it.g >= s.groups) {
    it.g -= s.groups;
    ++it.wl;
  }
}

// K5: y[b, 2h+i, 2w+j, c] = sum_{a, e in 0..2} f[a] f[e] sh[2h+i+a-1,
// 2w+j+e-1], sh the shuffled image with a reflect boundary, which at phase
// granularity is the edge clamp of the phase images: shuffled offset
// m = i + a - 1 reads phase row m & 1 of block h + (m >> 1), clamped to
// [0, H).  The four outputs (i, j) of a pixel read rows r = i + a of
// {h - 1 phase row 1, h row 0, h row 1, h + 1 row 0} and columns e + j of
// {w - 1 phase column 1, w column 0, w column 1, w + 1 column 0}; streamed
// in r, then column order, each output's nine taps arrive a-major, e-minor.
// Grid (strips, row runs, B); y is [B, 2H, 2W, C].
template <typename Tin, typename Tout, int V>
__global__ void __launch_bounds__(kMaxThreads<V>) fwd_kernel(const Tin* __restrict__ x,
                                                          Tout* __restrict__ y, const Strip s) {
  extern __shared__ __align__(16) char smem[];
  const int H = s.H, W = s.W, C = s.C;
  const int w0 = blockIdx.x * s.sw, h0 = blockIdx.y * s.rh, b = blockIdx.z;
  const int h1 = min(h0 + s.rh, H);
  // the strip's pixels w0 - 1 .. w0 + sw (plane pixel p is column w0 - 1 + p),
  // those inside the image copied
  const int clo = max(w0 - 1, 0), n = min(w0 + s.sw, W - 1) - clo + 1, p0 = clo - (w0 - 1);
  const size_t row_bytes = (size_t)W * s.pb;
  const char* xs = reinterpret_cast<const char*>(x) + ((size_t)b * H * W + clo) * s.pb;
  auto src = [&](int r) { return xs + (size_t)clampi(r, H - 1) * row_bytes; };
  auto slot = [&](int r) { return smem + ((r - h0 + 1) & (kRing - 1)) * s.slot; };
  auto issue = [&](int r) {  // row r into its slot, if a row of this run needs it
    if (r <= h1) copy_run(plane_base(slot(r), src(r), p0, s), src(r), p0, n, s);
    cp_commit();
  };

#pragma unroll 1
  for (int r = h0 - 1; r < h0 - 1 + kRing; ++r) issue(r);

  constexpr float f[3] = {0.25f, 0.5f, 0.25f};
  constexpr int sz = sizeof(Tin);
  const Items first = first_item(s);
#pragma unroll 1
  for (int h = h0; h < h1; ++h) {
    cp_wait<1>();  // this thread's copies of row h + 1
    __syncthreads();
    // phase row 1 of h - 1, rows 0 and 1 of h, row 0 of h + 1
    const char* rows[4] = {plane_base(slot(h - 1), src(h - 1), p0, s) + 2 * C * sz,
                           plane_base(slot(h), src(h), p0, s),
                           plane_base(slot(h), src(h), p0, s) + 2 * C * sz,
                           plane_base(slot(h + 1), src(h + 1), p0, s)};
    Tout* yrow = y + ((size_t)b * 2 * H + 2 * h) * 2 * W * C;
    Items it = first;
#pragma unroll 1
    for (int k = threadIdx.x; k < s.items; k += blockDim.x, next_item(it, s)) {
      const int w = w0 + it.wl;
      if (w >= W) continue;
      const int c0 = it.g * V;
      // plane pixels of columns w - 1, w, w + 1 (clamped)
      const int pm = w > 0 ? it.wl : it.wl + 1, pc = it.wl + 1, pp = w + 1 < W ? it.wl + 2 : pc;
      const int cols[4] = {pm * s.ps + (C + c0) * sz, pc * s.ps + c0 * sz,
                           pc * s.ps + (C + c0) * sz, pp * s.ps + c0 * sz};
      float acc[2][2][V];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int u = 0; u < V; ++u) acc[i][j][u] = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float v[V];
          load_vec<V>(rows[r] + cols[q], v, x);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int a = r - i;
            if (a < 0 || a > 2) continue;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int e = q - j;
              if (e < 0 || e > 2) continue;
#pragma unroll
              for (int u = 0; u < V; ++u) acc[i][j][u] = __fmaf_rn(f[a] * f[e], v[u], acc[i][j][u]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          store_vec<V>(yrow + ((size_t)i * 2 * W + 2 * w + j) * C + c0, acc[i][j]);
    }
    __syncthreads();  // every thread is done with the slot of row h - 1
    issue(h + 3);
  }
  cp_wait<0>();
}

// K6: dx [B, H, W, 4C] = the adjoint of the forward.  dx[b, h, w, k*C + c]
// at shuffled position (M, N) = (2h + k/2, 2w + k%2) sums dy rows M - 1,
// M, M + 1 with weights w_prev0(M), 0.5, w_next0(M, 2H), each row first
// summed over columns N - 1, N, N + 1 with w_prev0(N), 0.5, w_next0(N, 2W)
// (the plain version's order; a missing neighbour is read clamped and
// weighted 0).  A pixel's four phases read dy rows 2h - 1 .. 2h + 2 and
// columns 2w - 1 .. 2w + 2.  Grid (strips, row runs, B).
template <typename Tin, typename Tout, int V>
__global__ void __launch_bounds__(kMaxThreads<V>) bwd_kernel(const Tin* __restrict__ dy,
                                                          Tout* __restrict__ dx, const Strip s) {
  extern __shared__ __align__(16) char smem[];
  const int H = s.H, W = s.W, C = s.C, L = 2 * H, Lc = 2 * W;
  const int w0 = blockIdx.x * s.sw, h0 = blockIdx.y * s.rh, b = blockIdx.z;
  const int h1 = min(h0 + s.rh, H);
  // dy columns 2 w0 - 1 .. 2 w0 + 2 sw (plane pixel p is column 2 w0 - 1 + p)
  const int clo = max(2 * w0 - 1, 0), n = min(2 * w0 + 2 * s.sw, Lc - 1) - clo + 1;
  const int p0 = clo - (2 * w0 - 1);
  const size_t row_bytes = (size_t)Lc * s.pb;
  const char* ds = reinterpret_cast<const char*>(dy) + ((size_t)b * L * Lc + clo) * s.pb;
  // dy row 2t + e of pair t (clamped to the image)
  auto src = [&](int t, int e) { return ds + (size_t)(2 * clampi(t, H - 1) + e) * row_bytes; };
  auto plane = [&](int t, int e) {
    return smem + ((t - h0 + 1) & (kRing - 1)) * s.slot + e * s.plane;
  };
  auto base = [&](int t, int e) { return plane_base(plane(t, e), src(t, e), p0, s); };
  auto issue = [&](int t) {
    if (t <= h1)
      for (int e = 0; e < 2; ++e) copy_run(base(t, e), src(t, e), p0, n, s);
    cp_commit();
  };

#pragma unroll 1
  for (int t = h0 - 1; t < h0 - 1 + kRing; ++t) issue(t);

  constexpr int sz = sizeof(Tin);
  const Items first = first_item(s);
#pragma unroll 1
  for (int h = h0; h < h1; ++h) {
    cp_wait<1>();
    __syncthreads();
    // dy rows 2h - 1, 2h, 2h + 1, 2h + 2
    const char* rows[4] = {base(h - 1, 1), base(h, 0), base(h, 1), base(h + 1, 0)};
    const float wpr[2] = {w_prev0(2 * h), w_prev0(2 * h + 1)};
    const float wnr[2] = {w_next0(2 * h, L), w_next0(2 * h + 1, L)};
    Tout* dxrow = dx + ((size_t)b * H + h) * W * 4 * C;
    Items it = first;
#pragma unroll 1
    for (int k = threadIdx.x; k < s.items; k += blockDim.x, next_item(it, s)) {
      const int w = w0 + it.wl;
      if (w >= W) continue;
      const int c0 = it.g * V;
      // plane pixels of columns 2w - 1 .. 2w + 2 (clamped)
      const int q1 = 2 * it.wl + 1;
      const int qs[4] = {w > 0 ? q1 - 1 : q1, q1, q1 + 1, 2 * w + 2 < Lc ? q1 + 2 : q1 + 1};
      const float wpc[2] = {w_prev0(2 * w), w_prev0(2 * w + 1)};
      const float wnc[2] = {w_next0(2 * w, Lc), w_next0(2 * w + 1, Lc)};
      float acc[2][2][V];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int u = 0; u < V; ++u) acc[i][j][u] = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float rs[2][V];  // row r summed over the columns around N = 2w, 2w + 1
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int u = 0; u < V; ++u) rs[j][u] = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float v[V];
          load_vec<V>(rows[r] + qs[q] * s.ps + c0 * sz, v, dy);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int e = q - j;
            if (e < 0 || e > 2) continue;
            const float wt = e == 0 ? wpc[j] : e == 1 ? 0.5f : wnc[j];
#pragma unroll
            for (int u = 0; u < V; ++u) rs[j][u] = __fmaf_rn(wt, v[u], rs[j][u]);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int a = r - i;
          if (a < 0 || a > 2) continue;
          const float wt = a == 0 ? wpr[i] : a == 1 ? 0.5f : wnr[i];
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int u = 0; u < V; ++u) acc[i][j][u] = __fmaf_rn(wt, rs[j][u], acc[i][j][u]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          store_vec<V>(dxrow + (size_t)w * 4 * C + (2 * i + j) * C + c0, acc[i][j]);
    }
    __syncthreads();  // every thread is done with the slot of row h - 1
    issue(h + 3);
  }
  cp_wait<0>();
}

// ---------------------------------------------------------------------------
// host side

// The widest vector (up to 16 bytes of Tin) that C and both pointers allow
template <typename Tin, typename Tout>
inline int vector_width(int C, const void* in, const void* out) {
  int v = 16 / (int)sizeof(Tin);
  while (v > 1 && (C % v || (uintptr_t)in % (v * sizeof(Tin)) ||
                   (uintptr_t)out % (v * sizeof(Tout))))
    v >>= 1;
  return v;
}

// The plan's two choices, from readings on an H100 (tools/torch_stencil_sweep.py;
// PERF.md, section 6)
constexpr int kItems = 512;      // (pixel, channel group) items a strip's row aims at
constexpr int kMaxSlot = 16384;  // slot bytes above which a strip is narrowed

// The geometry of a launch (bwd: K6; `regs` the kernel's registers per
// thread), and its grid and block.  Strips are the widest power of two up
// to 64 pixels whose items first reach kItems, narrowed while a slot is
// over kMaxSlot bytes; a warp's 16-byte reads of narrow channel blocks
// (16-64 bytes) take a pixel stride that puts the pixels it spans on
// different banks.  The rows are cut into runs so that the grid fills the
// card's SMs at most once at the occupancy that threads, registers and the
// ring's shared memory allow.
inline Strip plan(int B, int H, int W, int C, int in_size, int V, bool bwd, const void* in,
                  int sms, int regs, dim3* grid, int* threads, size_t* smem) {
  Strip s{};
  s.H = H, s.W = W, s.C = C;
  s.groups = C / V;
  s.pb = (bwd ? C : 4 * C) * in_size;
  const int blk = C * in_size, step = bwd ? 2 : 1;
  s.ps = s.pb;
  if (blk % 16 == 0 && blk < 128 && (uintptr_t)in % 16 == 0)
    for (int pad = 16; pad < 128; pad += 16)
      if (step * (s.pb + pad) % 128 == blk) {
        s.ps = s.pb + pad;
        break;
      }
  // a plane: room for the slack, a shift of up to 15 bytes and a copy's rounding
  auto slot_bytes = [&](int sw) {
    const int npix = bwd ? 2 * sw + 2 : sw + 2;
    return (bwd ? 2 : 1) * (((npix * s.ps + 15) & ~15) + 3 * kSlack);
  };
  s.sw = 1;
  while (s.sw * s.groups < kItems && 2 * s.sw <= W && s.sw < 64) s.sw *= 2;
  while (s.sw > 1 && slot_bytes(s.sw) > kMaxSlot) s.sw /= 2;
  s.items = s.sw * s.groups;
  s.npix = bwd ? 2 * s.sw + 2 : s.sw + 2;
  s.slot = slot_bytes(s.sw);
  s.plane = bwd ? s.slot / 2 : s.slot;
  const int max_threads = V == 1 ? kMaxThreads<1> : kMaxThreads<2>;
  *threads = s.items < max_threads ? (s.items + 31) & ~31 : max_threads;
  *smem = (size_t)kRing * s.slot;
  // CTAs per SM by threads, registers (allocated per warp in steps of 256)
  // and shared memory
  int per_sm = 2048 / *threads < 32 ? 2048 / *threads : 32;
  const int by_regs = 65536 / (*threads / 32 * (((regs + 7) & ~7) * 32));
  const int by_smem = (int)(233472 / (*smem + 1024));
  per_sm = per_sm < by_regs ? per_sm : by_regs;
  per_sm = per_sm < by_smem ? per_sm : by_smem;
  per_sm = per_sm > 1 ? per_sm : 1;
  const int strips = (W + s.sw - 1) / s.sw;
  long long runs = (long long)per_sm * sms / ((long long)B * strips);
  runs = runs < 1 ? 1 : (runs > H ? H : runs);
  s.rh = (int)((H + runs - 1) / runs);
  *grid = dim3(strips, (H + s.rh - 1) / s.rh, B);
  return s;
}

// Plan and launch the kernel of one direction (kBwd: K6) and vector width.
// Internal linkage: several libraries build from this header, each with its
// own copy of the kernel, and the function's statics record that copy's
// attributes (an inline function's statics would be one object shared by
// every loaded library, and a library would skip raising its own kernel's
// shared-memory limit after another raised its own).
template <typename Tin, typename Tout, int V, bool kBwd>
static inline int launch(const Tin* in, Tout* out, int B, int H, int W, int C, int sms,
                         cudaStream_t stream) {
  void (*kernel)(const Tin*, Tout*, Strip);
  if constexpr (kBwd)
    kernel = bwd_kernel<Tin, Tout, V>;
  else
    kernel = fwd_kernel<Tin, Tout, V>;
  // the kernel's registers per thread, read once; its largest shared-memory
  // request so far, so that a launch that needs no more sets nothing (nor
  // during a CUDA graph's capture)
  static int regs = 0;
  static size_t allowed = 48 * 1024;
  if (regs == 0) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
    if (err != cudaSuccess) return (int)err;
    regs = a.numRegs;
  }
  dim3 grid;
  int threads;
  size_t smem;
  const Strip s = plan(B, H, W, C, sizeof(Tin), V, kBwd, in, sms, regs, &grid, &threads, &smem);
  if (smem > 232448 || grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  if (smem > allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  kernel<<<grid, threads, smem, stream>>>(in, out, s);
  return (int)cudaGetLastError();
}

inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

// One direction at the widest vector the shapes and pointers allow
template <typename Tin, typename Tout, bool kBwd>
int launch_dir(const void* in_, void* out_, int B, int H, int W, int C, cudaStream_t stream) {
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  const Tin* in = static_cast<const Tin*>(in_);
  Tout* out = static_cast<Tout*>(out_);
  const int V = vector_width<Tin, Tout>(C, in, out);
  if constexpr (sizeof(Tin) == 2)
    if (V == 8) return launch<Tin, Tout, 8, kBwd>(in, out, B, H, W, C, sms, stream);
  if (V == 4) return launch<Tin, Tout, 4, kBwd>(in, out, B, H, W, C, sms, stream);
  if (V == 2) return launch<Tin, Tout, 2, kBwd>(in, out, B, H, W, C, sms, stream);
  return launch<Tin, Tout, 1, kBwd>(in, out, B, H, W, C, sms, stream);
}

// Launch either direction on `stream`; returns the cudaError_t of the launch
// (a batch or a run count over 65535 or slots over the shared memory of an
// SM are refused there).
template <typename Tin, typename Tout>
int launch_fwd(const void* x, void* y, int B, int H, int W, int C, cudaStream_t stream) {
  return launch_dir<Tin, Tout, false>(x, y, B, H, W, C, stream);
}

template <typename Tin, typename Tout>
int launch_bwd(const void* dy, void* dx, int B, int H, int W, int C, cudaStream_t stream) {
  return launch_dir<Tin, Tout, true>(dy, dx, B, H, W, C, stream);
}

}  // namespace stencil
