// Baseline JPEG decoding for the data factory's frames, with cv2.imread's
// pixels (libjpeg-turbo's defaults): the entropy decoder in host C++ and the
// pixel stage as two CUDA kernels.
//
// No TPU kernel is replaced: the JAX package reads its raw frames with
// cv2.imread (gazenerf_tpu/preprocess/driver.py:238), and this is the port's
// counterpart of libjpeg-turbo's work there.  The plain versions, which this
// file follows operation for operation, are gazenerf_tpu_torch/utils/jpeg.py
// (entropy_decode_reference, pixels_reference); kernels/jpeg.py binds both.
//
// jpeg_entropy_decode (host): jdhuff.c's sequential Huffman decoder with
// jdmarker.c's restart handling over the stream libjpeg's stdio source hands
// out (the file, then FF D9 over and over).  It is sequential by nature and
// writes int16 coefficients (natural order, every block of every component
// plane, dummy blocks included) into a buffer the caller pinned.
//
// jpeg_pixels (device): launch 1 dequantizes and runs the integer IDCT
// (jidctint.c in the arithmetic of libjpeg-turbo's x86 SIMD, which cv2 runs)
// per 8 x 8 block into the component planes, eight threads a block (a column
// each in pass 1, a row each in pass 2, the workspace in shared memory);
// launch 2 upsamples (jdsample.c: fancy h2v1, h1v2, h2v2, box), converts
// YCbCr to BGR (jdcolor.c's tables) and crops, one thread per output pixel.
// Bound: bytes.  The coefficients (128 bytes a block) are read once and the
// BGR frame written once; the planes in between are a third of the frame
// (4:2:0) and stay mostly in the 50 MB L2 at the strip sizes launch 2 reads
// them in; every operation is a few integer ops per byte.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__
#else
#define HD
#endif

namespace {

// ---------------------------------------------------------------- entropy

constexpr int kRst0 = 0xD0, kSof0 = 0xC0;
constexpr int kWarnHitMarker = 1, kWarnEof = 2, kWarnResync = 4;

// jutils.c jpeg_natural_order, 16 extra entries of 63 for corrupt runs
constexpr int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// A Huffman table over every 16-bit window: length << 8 | symbol; 17 << 8
// where no code starts (jpeg_huff_decode reads 17 bits and gives 0).  The
// decoder looks a window's top 10 bits up first (`fast`: the entry of every
// code of up to 10 bits, 0 for longer ones), which keeps the common codes'
// entries in the first-level cache, and the whole window only after a 0.
bool build_lookup(const uint8_t* bits, const uint8_t* vals, std::vector<uint16_t>& table) {
  table.assign(65536, uint16_t(17 << 8));
  unsigned code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    for (int i = 0; i < bits[len - 1]; ++i) {
      if (code >= (1u << len)) return false;
      const unsigned span = 1u << (16 - len);
      std::fill(table.begin() + code * span, table.begin() + (code + 1) * span,
                uint16_t((len << 8) | vals[k]));
      ++code;
      ++k;
    }
    code <<= 1;
  }
  return true;
}

void build_fast(const std::vector<uint16_t>& table, uint16_t* fast) {
  for (int i = 0; i < 1024; ++i) {
    const uint16_t e = table[i << 6];
    fast[i] = (e >> 8) <= 10 ? e : 0;
  }
}

// The bit reader of jdhuff.c over the stdio source's stream.  It stops at a
// marker (unread_marker); past it, it hands out zero bits and records that
// a bit past the data was consumed (what sets insufficient_data).
struct Reader {
  const uint8_t* d;
  int64_t n, pos;
  uint64_t buf = 0;
  int bits = 0, pad = 0;  // bits in buf, of which the last `pad` are zero fill
  int marker = 0;         // the marker the reader stopped at (pos is past it)
  bool overrun = false;
  int warn = 0;

  uint8_t byte() {
    const int64_t p = pos++;
    if (p < n) return d[p];
    return ((p - n) & 1) ? 0xD9 : 0xFF;
  }
  void found(int m) {
    marker = m;
    if (pos > n) warn |= kWarnEof;
  }
  // jdmarker.c next_marker: skip to an FF, swallow fill FFs, step over FF 00
  void next_marker() {
    for (;;) {
      int c = byte();
      while (c != 0xFF) c = byte();
      do c = byte(); while (c == 0xFF);
      if (c != 0) return found(c);
    }
  }
  void fill() {
    // four bytes at once while none of them is FF (no stuffing, no marker)
    while (!marker && bits <= 32 && pos + 4 <= n) {
      const uint32_t x = (uint32_t(d[pos]) << 24) | (uint32_t(d[pos + 1]) << 16) |
                         (uint32_t(d[pos + 2]) << 8) | uint32_t(d[pos + 3]);
      const uint32_t y = ~x;  // a zero byte of y is an FF byte of x
      if ((y - 0x01010101u) & ~y & 0x80808080u) break;
      buf = (buf << 32) | x;
      bits += 32;
      pos += 4;
    }
    while (bits <= 56) {
      int c = 0;
      if (!marker) {
        c = byte();
        if (c == 0xFF) {
          do c = byte(); while (c == 0xFF);
          if (c == 0) {
            c = 0xFF;
          } else {
            found(c);
            c = 0;
          }
        }
      }
      buf = (buf << 8) | uint64_t(c);
      bits += 8;
      if (marker) pad += 8;
    }
  }
  // the next 32 bits: a code of up to 17 bits and its up to 15 extra bits
  unsigned peek32() {
    if (bits < 32) fill();
    return unsigned(buf >> (bits - 32));
  }
  void skip(int k) {
    bits -= k;
    if (bits < pad) {
      overrun = true;
      pad = bits;
    }
  }
  void discard() {  // process_restart throws the bit buffer away
    buf = 0;
    bits = pad = 0;
    overrun = false;
  }
};

// The `s` extra bits that follow a code of `len` bits at the top of `w`,
// HUFF_EXTEND'ed.
inline int extra(unsigned w, unsigned len, int s) {
  const int r = int((w << len) >> (32 - s));
  return r >= (1 << (s - 1)) ? r : r - (1 << s) + 1;
}

// jpeg_resync_to_restart: where RST`desired` was due and reader.marker came.
void resync(Reader& r, int desired) {
  for (;;) {
    const int m = r.marker;
    int action;
    if (m < kSof0) action = 2;
    else if (m < kRst0 || m > kRst0 + 7) action = 3;
    else if (m == kRst0 + ((desired + 1) & 7) || m == kRst0 + ((desired + 2) & 7)) action = 3;
    else if (m == kRst0 + ((desired - 1) & 7) || m == kRst0 + ((desired - 2) & 7)) action = 2;
    else action = 1;
    if (action == 1) {
      r.marker = 0;
      return;
    }
    if (action == 3) return;
    r.next_marker();
  }
}

}  // namespace

// The scan's coefficients.  comp: per scan component (n_scan of them) h, v,
// blocks_w, first block; tables: per scan component the DC then the AC table,
// each 16 counts and 256 values.  out: n_blocks x 64 int16.  *warn gets the
// WARN_* bits of utils/jpeg.py.  Returns 0, or 1 for a table that is not a
// prefix code.
extern "C" int jpeg_entropy_decode(const uint8_t* data, long long n, long long scan_start,
                                   int n_scan, const int* comp, const uint8_t* tables,
                                   int mcus_x, int mcus_y, int restart_interval,
                                   int16_t* out, int* warn) {
  std::vector<uint16_t> dc[4], ac[4];
  uint16_t fast_dc[4][1024], fast_ac[4][1024];
  for (int k = 0; k < n_scan; ++k) {
    const uint8_t* t = tables + k * 2 * 272;
    if (!build_lookup(t, t + 16, dc[k]) || !build_lookup(t + 272, t + 288, ac[k])) return 1;
    build_fast(dc[k], fast_dc[k]);
    build_fast(ac[k], fast_ac[k]);
  }
  struct Blk { int k, by, bx; };
  std::vector<Blk> mcu;
  const bool single = n_scan == 1;
  for (int k = 0; k < n_scan; ++k)
    for (int by = 0; by < (single ? 1 : comp[4 * k + 1]); ++by)
      for (int bx = 0; bx < (single ? 1 : comp[4 * k]); ++bx) mcu.push_back({k, by, bx});

  Reader r{data, n, scan_start};
  const int64_t n_mcus = int64_t(mcus_x) * mcus_y;
  int next_rst = 0, last_dc[4] = {0, 0, 0, 0};
  bool insufficient = false;
  for (int64_t m = 0; m < n_mcus; ++m) {
    if (restart_interval && m && m % restart_interval == 0) {  // process_restart
      r.discard();
      if (!r.marker) r.next_marker();
      if (r.marker == kRst0 + next_rst) {
        r.marker = 0;
      } else {
        r.warn |= kWarnResync;
        resync(r, next_rst);
      }
      next_rst = (next_rst + 1) & 7;
      for (int& v : last_dc) v = 0;
      if (!r.marker) insufficient = false;
    }
    const int64_t my = m / mcus_x, mx = m % mcus_x;
    for (const Blk& b : mcu) {
      const int* c = comp + 4 * b.k;
      const int64_t blk = c[3] + (single ? m : (my * c[1] + b.by) * c[2] + mx * c[0] + b.bx);
      int16_t* block = out + 64 * blk;
      std::memset(block, 0, 64 * sizeof(int16_t));
      if (insufficient) continue;
      unsigned w = r.peek32();
      unsigned e = fast_dc[b.k][w >> 22];
      if (!e) e = dc[b.k][w >> 16];
      int s = e & 0xFF;
      r.skip((e >> 8) + s);
      if (s) s = extra(w, e >> 8, s);
      // last_dc_val grows in unsigned arithmetic; the block keeps its low 16 bits
      last_dc[b.k] = int(uint32_t(last_dc[b.k]) + uint32_t(s));
      block[0] = int16_t(uint16_t(uint32_t(last_dc[b.k])));
      const std::vector<uint16_t>& act = ac[b.k];
      const uint16_t* fast = fast_ac[b.k];
      for (int k = 1; k < 64; ++k) {
        w = r.peek32();
        e = fast[w >> 22];
        if (!e) e = act[w >> 16];
        const int rr = (e >> 4) & 15;
        s = e & 15;
        r.skip((e >> 8) + s);
        if (s) {
          k += rr;
          block[kNatural[k]] = int16_t(extra(w, e >> 8, s));
        } else {
          if (rr != 15) break;
          k += 15;
        }
      }
    }
    if (!insufficient && r.overrun) {
      insufficient = true;
      r.warn |= kWarnHitMarker;
    }
  }
  if (!r.marker) r.next_marker();  // the marker that ends the last segment
  *warn = r.warn;
  return 0;
}

// ---------------------------------------------------------------- pixels

namespace {

constexpr int kFullsize = 0, kH2V1 = 1, kH1V2 = 2, kH2V2 = 3, kBox = 4;
constexpr int kGrey = 0, kYcc = 1, kRgb = 2;

struct Comp {
  long long block0;  // first block in the coefficient buffer
  long long plane0;  // first byte of its plane
  int blocks_w, blocks_h, dw, dh, method, hexp, vexp;
};

struct Layout {
  int n_comp, width, height, color;
  long long n_blocks;
  Comp c[3];
  int qt[3][64];  // natural order
};

HD inline int wrap16(int x) { return int(int16_t(uint16_t(uint32_t(x)))); }
HD inline int sat16(int x) { return x < -32768 ? -32768 : (x > 32767 ? 32767 : x); }

// One pass of jpeg_idct_islow on int16 inputs x[0..7] in the arithmetic of
// jidctint-avx2.asm: x0 +/- x4, z3 = x7 + x3 and z4 = x5 + x1 are 16-bit
// sums; the rest is exact modulo 2^32 (uint32 here); each output DESCALEd by
// `shift` and saturated to int16.
HD inline void idct_1d(const int* x, int shift, int* out) {
  typedef uint32_t u;
  const u z2 = u(x[2]), z3e = u(x[6]);
  const u z1e = (z2 + z3e) * 4433u;
  const u tmp2e = z1e + z3e * u(-15137);
  const u tmp3e = z1e + z2 * 6270u;
  const u tmp0e = u(wrap16(x[0] + x[4])) << 13;
  const u tmp1e = u(wrap16(x[0] - x[4])) << 13;
  const u tmp10 = tmp0e + tmp3e, tmp13 = tmp0e - tmp3e;
  const u tmp11 = tmp1e + tmp2e, tmp12 = tmp1e - tmp2e;
  u tmp0 = u(x[7]), tmp1 = u(x[5]), tmp2 = u(x[3]), tmp3 = u(x[1]);
  u z1 = tmp0 + tmp3, zz2 = tmp1 + tmp2;
  u z3 = u(wrap16(x[7] + x[3])), z4 = u(wrap16(x[5] + x[1]));
  const u z5 = (z3 + z4) * 9633u;
  tmp0 *= 2446u;
  tmp1 *= 16819u;
  tmp2 *= 25172u;
  tmp3 *= 12299u;
  z1 *= u(-7373);
  zz2 *= u(-20995);
  z3 = z3 * u(-16069) + z5;
  z4 = z4 * u(-3196) + z5;
  tmp0 += z1 + z3;
  tmp1 += zz2 + z4;
  tmp2 += zz2 + z3;
  tmp3 += z1 + z4;
  const u half = 1u << (shift - 1);
  const u v[8] = {tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
                  tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3};
  for (int i = 0; i < 8; ++i) out[i] = sat16(int(v[i] + half) >> shift);
}

// jdsample.c for one component at output pixel (x, y): the methods' edges
// repeat the component's last real column and row (clamps to dw, dh).
HD inline int upsample(const uint8_t* plane, int pitch, const Comp& c, int x, int y) {
  auto at = [&](int i, int j) { return int(plane[(long long)i * pitch + j]); };
  auto clampi = [](int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); };
  switch (c.method) {
    case kFullsize:
      return at(y, x);
    case kBox:
      return at(y / c.vexp, x / c.hexp);
    case kH2V1: {
      const int j = x >> 1, odd = x & 1, jn = clampi(j - 1 + 2 * odd, c.dw - 1);
      return (3 * at(y, j) + at(y, jn) + 1 + odd) >> 2;
    }
    case kH1V2: {
      const int i = y >> 1, odd = y & 1, in = clampi(i - 1 + 2 * odd, c.dh - 1);
      return (3 * at(i, x) + at(in, x) + 1 + odd) >> 2;
    }
    default: {  // kH2V2
      const int i = y >> 1, in = clampi(i - 1 + 2 * (y & 1), c.dh - 1);
      const int j = x >> 1, odd = x & 1, jn = clampi(j - 1 + 2 * odd, c.dw - 1);
      const int near = 3 * at(i, j) + at(in, j), far = 3 * at(i, jn) + at(in, jn);
      return (3 * near + far + 8 - odd) >> 4;
    }
  }
}

HD inline uint8_t clamp255(int v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// jdcolor.c ycc_rgb_convert (SCALEBITS 16) written out for one pixel:
// FIX(1.40200) = 91881, FIX(1.77200) = 116130, FIX(0.71414) = 46802,
// FIX(0.34414) = 22554, ONE_HALF = 32768
HD inline void ycc_to_bgr(int y, int cb, int cr, uint8_t* bgr) {
  const int x_cb = cb - 128, x_cr = cr - 128;
  const int cr_r = (91881 * x_cr + 32768) >> 16;
  const int cb_b = (116130 * x_cb + 32768) >> 16;
  const int g = ((-22554 * x_cb + 32768) + (-46802 * x_cr)) >> 16;
  bgr[0] = clamp255(y + cb_b);
  bgr[1] = clamp255(y + g);
  bgr[2] = clamp255(y + cr_r);
}

#ifdef __CUDACC__

constexpr int kIdctThreads = 256;  // 32 blocks of 8 x 8, eight threads each

__global__ void idct_kernel(const int16_t* __restrict__ coef, uint8_t* __restrict__ planes,
                            Layout lay) {
  __shared__ int ws[kIdctThreads / 8][8][9];  // padded against bank conflicts
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long b = t >> 3;
  const int col = threadIdx.x & 7, local = threadIdx.x >> 3;
  const bool live = b < lay.n_blocks;
  int ci = 0;
  if (live)
    while (ci + 1 < lay.n_comp && b >= lay.c[ci + 1].block0) ++ci;
  const int* q = lay.qt[ci];
  // pass 1: this thread's column, dequantized in 16 bits (pmullw)
  int in[8], out[8];
  bool ac = false;
  for (int k = 0; k < 8; ++k) {
    const int v = live ? coef[b * 64 + k * 8 + col] : 0;
    in[k] = wrap16(v * q[k * 8 + col]);
    ac |= k > 0 && v != 0;
  }
  // a block whose rows 1-7 are all zero takes its DC terms shifted in 16 bits
  const unsigned lanes = __ballot_sync(0xFFFFFFFFu, ac);
  const bool dc_only = ((lanes >> (threadIdx.x & 24)) & 0xFFu) == 0;
  if (dc_only) {
    for (int k = 0; k < 8; ++k) out[k] = wrap16(in[0] * 4);  // psllw by PASS1_BITS
  } else {
    idct_1d(in, 11, out);
  }
  for (int k = 0; k < 8; ++k) ws[local][k][col] = out[k];
  __syncwarp();
  // pass 2: this thread's row, into the plane
  const int row = col;
  for (int k = 0; k < 8; ++k) in[k] = ws[local][row][k];
  idct_1d(in, 18, out);
  if (!live) return;
  const Comp& c = lay.c[ci];
  const long long local_b = b - c.block0;
  const long long by = local_b / c.blocks_w, bx = local_b % c.blocks_w;
  alignas(8) uint8_t px[8];
  for (int k = 0; k < 8; ++k) px[k] = clamp255(out[k] + 128);
  uint8_t* dst = planes + c.plane0 + (by * 8 + row) * (8LL * c.blocks_w) + bx * 8;
  *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(px);
}

__global__ void color_kernel(const uint8_t* __restrict__ planes, uint8_t* __restrict__ bgr,
                             Layout lay) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)lay.width * lay.height) return;
  const int y = int(t / lay.width), x = int(t % lay.width);
  int v[3];
  for (int ci = 0; ci < lay.n_comp; ++ci) {
    const Comp& c = lay.c[ci];
    v[ci] = upsample(planes + c.plane0, 8 * c.blocks_w, c, x, y);
  }
  uint8_t* o = bgr + 3 * t;
  if (lay.color == kYcc) {
    ycc_to_bgr(v[0], v[1], v[2], o);
  } else if (lay.color == kRgb) {
    o[0] = uint8_t(v[2]);
    o[1] = uint8_t(v[1]);
    o[2] = uint8_t(v[0]);
  } else {
    o[0] = o[1] = o[2] = uint8_t(v[0]);
  }
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__

// The pixel stage.  comp: per component block0, plane0, blocks_w, blocks_h,
// dw, dh, method, hexp, vexp (9 ints; offsets fit 31 bits at 65500^2 / 64
// blocks); qt: per component 64 ints.  planes: the component planes' bytes,
// scratch; bgr: height x width x 3.  Returns the CUDA error of the launches.
extern "C" int jpeg_pixels(const int16_t* coef, uint8_t* planes, uint8_t* bgr, int n_comp,
                           const int* comp, const int* qt, int width, int height, int color,
                           long long n_blocks, void* stream) {
  Layout lay{};
  lay.n_comp = n_comp;
  lay.width = width;
  lay.height = height;
  lay.color = color;
  lay.n_blocks = n_blocks;
  for (int i = 0; i < n_comp; ++i) {
    const int* p = comp + 9 * i;
    lay.c[i] = Comp{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8]};
    for (int k = 0; k < 64; ++k) lay.qt[i][k] = qt[64 * i + k];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long idct_threads = n_blocks * 8;
  idct_kernel<<<unsigned((idct_threads + kIdctThreads - 1) / kIdctThreads), kIdctThreads, 0, s>>>(
      coef, planes, lay);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const long long pixels = (long long)width * height;
  color_kernel<<<unsigned((pixels + 255) / 256), 256, 0, s>>>(planes, bgr, lay);
  return int(cudaGetLastError());
}

#endif  // __CUDACC__
