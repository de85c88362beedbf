// MPEG-4 Part 2 (Simple Profile) video decode on the card: the entropy
// stage of each VOP, the reconstruction and cv2's colour rule, as three
// kernels; plain C interface.
//
// The counterpart of the JAX package's cv2.VideoCapture (the video branch
// of dspnet_tpu/detect/detector.py:289): video decoding is not a TPU
// kernel. The three kernels replace FFmpeg's mpeg4videodec.c / h263dec.c
// macroblock layer (mp4v_parse_kernel), its dequantisation, simple IDCT and
// half-pel motion compensation (mpegvideo's unquantize, simple_idct,
// hpeldsp: mp4v_recon_kernel) and swscale's unscaled YUV420P -> BGR24
// converter (yuv420_to_bgr_kernel). The host (dspnet_torch/data/mpeg4.py)
// reads the container, the VOL and each VOP's header; the wrapper
// (dspnet_torch/data/mpeg4_cuda.py) copies a batch of VOPs' bytes in once
// through pinned memory on the caller's stream. Each kernel is held bit for
// bit to its plain version (mpeg4.parse_vop, mpeg4.recon_vop,
// mpeg4.yuv420_to_bgr), which cv2 5.0.0 equals on the committed forms.
//
// mp4v_parse_kernel: a warp per VOP (a block each), a batch of VOPs in one
// launch. Parsing a P-VOP needs no pixels of its reference, so the VOPs of a
// batch parse side by side. Lane 0 runs the VLC lookups (12-bit tables
// built by the host from mpeg4.py's tables, int16 in shared memory), the MV
// and DC/AC prediction state (FFmpeg's layouts, the rows prediction reads
// kept in shared memory) and the scans, and builds per macroblock its mode,
// quantiser, cbp and MVs and each block's quantised levels (raster order)
// in shared memory; the warp stores them. What bounds it: neither bytes nor
// operations but the serial chain of VLC symbols of one VOP; each link of
// it is a register or shared-memory step. Batching VOPs is what keeps the
// frame rate up. The kernel as it was before (one thread, every step a
// device-memory access) is kept in baselines/mp4v_parse_per_thread.cu as a
// yardstick.
//
// mp4v_recon_kernel: one launch per VOP in decode order (a P-VOP reads the
// one before it), one thread per 8x8 block: dequantisation (H.263, or MPEG
// with the VOL's matrices and the inter mismatch control), the simple IDCT
// in FFmpeg's integer order (int16 row store, the DC-only row shortcut),
// the half-pel prediction from the reference (edges clamped at the
// macroblock-aligned size; FFmpeg's clips of a 4MV source; its chroma MV
// rounding; rounding type 1 as FFmpeg's x86 put_no_rnd_pixels8 x2 / y2
// approximate it on 8-wide blocks), add and clip. What bounds it: bytes, the block's levels
// read and the prediction's samples read once, the block written once.
//
// yuv420_to_bgr_kernel: one thread per pixel: swscale's fixed-point
// BT.601 limited-range rule as its x86 SIMD path computes it (pmulhw's
// floor of each 16-bit product), the chroma of each 2x2 block shared. What
// bounds it: bytes, 1.5 bytes a pixel in and 3 out.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef MP4V_LAUNCH
#define MP4V_LAUNCH(kernel, grid, block, shared, stream) kernel<<<(grid), (block), (shared), (stream)>>>
#endif
// a kernel's dynamic shared memory (sized at launch)
#ifndef DYNAMIC_SHARED
#define DYNAMIC_SHARED(name) extern __shared__ __align__(16) uint8_t name[]
#endif
// the launch geometry's caps: threads a block, blocks of the parse's grid
// (a host emulation builds with small ones); the parse runs a warp a block
#ifndef MP4V_MAX_THREADS
#define MP4V_MAX_THREADS 1024
#endif
#ifndef MP4V_MAX_BLOCKS
#define MP4V_MAX_BLOCKS (1 << 30)
#endif
#ifndef MP4V_PARSE_THREADS
#define MP4V_PARSE_THREADS (MP4V_MAX_THREADS < 32 ? MP4V_MAX_THREADS : 32)
#endif

namespace {

constexpr int LUT_BITS = 12;
enum { L_INTRA_MCBPC, L_INTER_MCBPC, L_CBPY, L_MV, L_DC_LUM, L_DC_CHROM, L_INTRA_TCOEF, L_INTER_TCOEF };
constexpr int ESCAPE = 102;
enum { MODE_SKIP, MODE_INTER, MODE_INTER4V, MODE_INTRA };

// VOP table columns (mpeg4_cuda.VOP_FIELDS)
enum { V_OFFSET, V_BYTES, V_BIT, V_KIND, V_QP, V_FCODE, V_DC_THR, V_FIELDS };
// parse status codes
enum { OK = 0, E_VLC = 1, E_MARKER = 2, E_OVERRUN = 3, E_PACKET = 4, E_ESCAPE = 5, E_END = 6 };

__constant__ int8_t kZigzag[64] = {0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
                                   12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
                                   35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
                                   58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
__constant__ int8_t kAltH[64] = {0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14,
                                 13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
                                 30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
                                 46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
__constant__ int8_t kAltV[64] = {0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49,
                                 41, 33, 26, 18, 3,  11, 4,  12, 19, 27, 34, 42, 50, 58, 35, 43,
                                 51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44, 52, 60, 37, 45,
                                 53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};
__constant__ uint8_t kYDcScale[32] = {0,  8,  8,  8,  8,  10, 12, 14, 16, 17, 18, 19, 20, 21, 22, 23,
                                      24, 25, 26, 27, 28, 29, 30, 31, 32, 34, 36, 38, 40, 42, 44, 46};
__constant__ uint8_t kCDcScale[32] = {0,  8,  8,  8,  8,  9,  9,  10, 10, 11, 11, 12, 12, 13, 13, 14,
                                      14, 15, 15, 16, 16, 17, 17, 18, 18, 19, 20, 21, 22, 23, 24, 25};
__constant__ int8_t kQuantTab[4] = {-1, -2, 1, 2};
__constant__ uint8_t kChromaRound[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};

// ------------------------------------------------------------------ parse

// A VOP's bits through a 64-bit window: refilled a 32-bit word at a time from
// device memory, the next word loaded one refill ahead. Bits at and past the
// VOP's last byte read as 0 (as the plain reader's padding); pos counts bits
// from the VOP's start, derived from the window's place (pos()).
struct Reader {
  const uint32_t* words;  // the VOP's bytes as aligned words (from the word holding its first byte)
  uint64_t cache;         // the bits from pos on, left-aligned
  int next;               // the bit (of words) after the cache's last, a multiple of 32
  int lim;                // the bit past the VOP's last byte
  uint32_t ahead;         // the word at next
  int avail;              // valid bits in cache: 33 to 64 between reads
  int base;               // the bit of the VOP's first byte
  int size;  // bits
  int steps;  // VLC symbols read (the chain's steps)

  __device__ __forceinline__ uint32_t word(int bit) const {
    if (bit >= lim) return 0;
    const uint32_t v = __byte_perm(words[bit >> 5], 0, 0x0123);  // big-endian
    const int keep = lim - bit;
    return keep < 32 ? v & ~(0xFFFFFFFFu >> keep) : v;
  }
  __device__ __forceinline__ void refill() {
    cache |= (uint64_t)ahead << (32 - avail);
    avail += 32;
    next += 32;
    ahead = word(next);
  }
  __device__ void start(const uint8_t* data, int bit, int nbytes) {
    const uintptr_t a = (uintptr_t)data;
    words = (const uint32_t*)(a & ~(uintptr_t)3);
    base = (int)(a & 3) * 8;
    const int at = base + bit;
    lim = base + nbytes * 8;
    next = at & ~31;
    ahead = word(next);
    cache = 0;
    avail = 0;
    refill();
    refill();
    const int k = (int)(at & 31);
    cache <<= k;
    avail -= k;
    size = 8 * nbytes;
    steps = 0;
  }
  __device__ __forceinline__ int pos() const { return next - avail - base; }
  // n bits from `off` bits ahead, not consumed (1 <= n, off + n <= 33)
  __device__ __forceinline__ uint32_t peek_at(int off, int n) const { return (uint32_t)((cache << off) >> (64 - n)); }
  __device__ __forceinline__ uint32_t peek(int n) const { return peek_at(0, n); }
  // consume n bits, 0 <= n <= 32
  __device__ __forceinline__ void skip(int n) {
    cache <<= n;
    avail -= n;
    if (__builtin_expect(avail <= 32, 0)) refill();
  }
  __device__ __forceinline__ uint32_t read(int n) {
    const uint32_t v = n ? peek(n) : 0u;
    skip(n);
    return v;
  }
  __device__ __forceinline__ int read1() { return (int)read(1); }
};

// the tables in shared memory: the lookup tables of the six VLCs before the
// TCOEF ones, 6 x 4096 (symbol << 8 | length) as int16 (-1 where no code
// starts); the two TCOEF tables (intra, inter), indexed by the next 13
// bits, each entry a code and the sign bit after it: length (the sign's
// included) | last << 5 | the signed level << 8 | (run + 1) << 24, int32;
// T_ESCAPE for the escape (its 7 bits), -1 where no code starts; their LMAX
// / RMAX, int32 intra lmax[2][64], intra rmax[2][64], inter lmax, inter rmax
constexpr int TCOEF_BITS = LUT_BITS + 1;
constexpr int N_LUT = L_INTRA_TCOEF << LUT_BITS, N_TCOEF = 2 << TCOEF_BITS, N_MAXES = 512, T_ESCAPE = -2;

// a TCOEF code and its sign from its table: (last, run, level), consumed;
// false (E_VLC, or E_ESCAPE for the escape) where none
__device__ __forceinline__ bool tcoef(Reader& b, const int* tab, int* last, int* run, int* level, int* err) {
  b.steps++;
  const int e = tab[b.peek(TCOEF_BITS)];
  if (e < 0) {
    if (e == T_ESCAPE) b.skip(7);  // an escape inside an escape, read as the plain reader reads it
    *err = e == T_ESCAPE ? E_ESCAPE : E_VLC;
    return false;
  }
  b.skip(e & 31);
  *last = (e >> 5) & 1, *run = (e >> 24) - 1, *level = (int16_t)(e >> 8);
  return true;
}

__device__ __forceinline__ int vlc(Reader& b, const int16_t* lut, int table, int* err) {
  b.steps++;
  const int e = lut[table * (1 << LUT_BITS) + b.peek(LUT_BITS)];
  if (e < 0) {
    *err = E_VLC;
    return 0;
  }
  b.skip(e & 0xFF);
  return e >> 8;
}

__device__ __forceinline__ int mid3(int a, int b, int c) { return max(min(a, b), min(max(a, b), c)); }

__device__ __forceinline__ int sext(int v, int bits) {
  v &= (1 << bits) - 1;
  return (v >> (bits - 1)) ? v - (1 << bits) : v;
}

// The prediction state in FFmpeg's layouts (a block at (row, column) of a
// grid of the VOP's blocks padded by a row above and a column beside), kept
// in shared memory for the rows that prediction reads: rings of 3 rows of
// 8x8 luma blocks (the block row above the macroblock row and its two), 2
// rows of chroma blocks, 2 rows of macroblock quantisers. Everything lane 0
// runs is inlined into the kernel, so the state's pointers, the reader and
// the VOP's fields stay in registers.
struct Vop {
  // geometry
  int mbw, mbh, b8, mbs, kind, fcode, dc_thr, time_bits;
  // the rings (this VOP's own): luma, then chroma Cb and Cr (2 mbs entries each)
  int* dc_l;
  int* dc_c;
  int16_t* ac_l;
  int16_t* ac_c;
  int* mv;  // pairs
  int* qtab;
  const uint32_t* magic;  // magic[d] = 2^32 / d + 1 (d >= 2): n / d = umulhi(n, magic[d]) for 0 <= n < 2^16
  // state
  int qp, resync_x, resync_y, first_line, ac_pred;

  // a block's ring entry: luma (k 0) rows from -1 and columns from -1,
  // chroma (k 1, 2) the same on the macroblock grid
  __device__ __forceinline__ int at(int k, int r, int c) const {
    return k ? ((r + 1) & 1) * mbs + c + 1 : ((r + 1) % 3) * b8 + c + 1;
  }
  __device__ __forceinline__ int& dc_at(int k, int r, int c) {
    return k ? dc_c[(k - 1) * 2 * mbs + at(k, r, c)] : dc_l[at(0, r, c)];
  }
  __device__ __forceinline__ int16_t* ac_at(int k, int r, int c) {
    return k ? ac_c + 16 * ((k - 1) * 2 * mbs + at(k, r, c)) : ac_l + 16 * at(0, r, c);
  }
  // a luma block's MV: columns 0 to 2 mbw (the padding, which column -1 of
  // the row below also reads, as in FFmpeg's layout)
  __device__ __forceinline__ int* mv_at(int r, int c) {
    if (c < 0) {
      r -= 1;
      c += b8;
    }
    return mv + 2 * (((r + 1) % 3) * b8 + c);
  }
  __device__ __forceinline__ int& q_at(int y, int x) { return qtab[(y & 1) * mbw + x]; }
};

// a block's (plane, row, column)
__device__ __forceinline__ void block_pos(int y, int x, int blk, int* k, int* r, int* c) {
  if (blk < 4) {
    *k = 0;
    *r = 2 * y + (blk >> 1);
    *c = 2 * x + (blk & 1);
  } else {
    *k = blk - 3;
    *r = y;
    *c = x;
  }
}

// ff_h263_pred_motion with FFmpeg's first-slice-line rules
__device__ __forceinline__ void pred_mv(Vop& v, int y, int x, int blk, int* px, int* py) {
  const int r = 2 * y + (blk >> 1), c = 2 * x + (blk & 1);
  int* A = v.mv_at(r, c - 1);
  const int off = blk == 0 ? 2 : (blk == 3 ? -1 : 1);
  if (v.first_line && blk < 3) {
    if (blk == 0) {
      if (x == v.resync_x) {
        *px = *py = 0;
      } else if (x + 1 == v.resync_x) {
        const int* C = v.mv_at(r - 1, c + off);
        if (x == 0) {
          *px = C[0];
          *py = C[1];
        } else {
          *px = mid3(A[0], 0, C[0]);
          *py = mid3(A[1], 0, C[1]);
        }
      } else {
        *px = A[0];
        *py = A[1];
      }
      return;
    }
    if (blk == 1) {
      if (x + 1 == v.resync_x) {
        const int* C = v.mv_at(r - 1, c + off);
        *px = mid3(A[0], 0, C[0]);
        *py = mid3(A[1], 0, C[1]);
      } else {
        *px = A[0];
        *py = A[1];
      }
      return;
    }
    const int* B = v.mv_at(r - 1, c);
    const int* C = v.mv_at(r - 1, c + off);
    if (x == v.resync_x) A[0] = A[1] = 0;
    *px = mid3(A[0], B[0], C[0]);
    *py = mid3(A[1], B[1], C[1]);
    return;
  }
  const int* B = v.mv_at(r - 1, c);
  const int* C = v.mv_at(r - 1, c + off);
  *px = mid3(A[0], B[0], C[0]);
  *py = mid3(A[1], B[1], C[1]);
}

__device__ __forceinline__ int read_mv(Reader& b, const int16_t* lut, int pred, int fcode, int* err) {
  int code = vlc(b, lut, L_MV, err);
  if (code == 0) return pred;
  int sign = b.read1();
  int val = code;
  int shift = fcode - 1;
  if (shift) val = (((val - 1) << shift) | (int)b.read(shift)) + 1;
  if (sign) val = -val;
  return sext(val + pred, 5 + fcode);
}

__device__ __forceinline__ int pred_dc(Vop& v, int y, int x, int blk, int level, int scale, int* dir) {
  int k, r, c;
  block_pos(y, x, blk, &k, &r, &c);
  int a = v.dc_at(k, r, c - 1), bb = v.dc_at(k, r - 1, c - 1), cc = v.dc_at(k, r - 1, c);
  if (v.first_line && blk != 3) {
    if (blk != 2) bb = cc = 1024;
    if (blk != 1 && x == v.resync_x) bb = a = 1024;
  }
  if (x == v.resync_x && y == v.resync_y + 1 && (blk == 0 || blk == 4 || blk == 5)) bb = 1024;
  int pred;
  if (abs(a - bb) < abs(bb - cc)) {
    pred = cc;
    *dir = 1;
  } else {
    pred = a;
    *dir = 0;
  }
  level += (int)__umulhi((uint32_t)(pred + (scale >> 1)), v.magic[scale]);  // pred <= 2047, scale 8-46
  int val = level * scale;
  if (val & ~2047) val = val < 0 ? 0 : 2047;
  v.dc_at(k, r, c) = val;
  return level;
}

// (a + b / 2) / b rounded as FFmpeg's ROUNDED_DIV, b 1-31; a reciprocal
// multiply where the numerator is below 2^16 (always, but for AC values
// beyond +-2047)
__device__ __forceinline__ int rounded_div(const Vop& v, int a, int b) {
  const uint32_t n = (uint32_t)(a > 0 ? a : -a) + (b >> 1);
  const int q = b == 1 ? (int)n : (n < 65536u ? (int)__umulhi(n, v.magic[b]) : (int)(n / b));
  return a > 0 ? q : -q;
}

__device__ __forceinline__ void pred_ac(Vop& v, int y, int x, int blk, int16_t* blk64, int dir) {
  int k, r, c;
  block_pos(y, x, blk, &k, &r, &c);
  if (v.ac_pred) {
    if (dir == 0) {
      const int16_t* src = v.ac_at(k, r, c - 1);
      const int nq = x > 0 ? v.q_at(y, x - 1) : v.qp;
      if (x == 0 || v.qp == nq || blk == 1 || blk == 3) {
        for (int t = 1; t < 8; ++t) blk64[t << 3] += src[t];
      } else {
        for (int t = 1; t < 8; ++t) blk64[t << 3] += rounded_div(v, src[t] * nq, v.qp);
      }
    } else {
      const int16_t* src = v.ac_at(k, r - 1, c);
      const int nq = y > 0 ? v.q_at(y - 1, x) : v.qp;
      if (y == 0 || v.qp == nq || blk == 2 || blk == 3) {
        for (int t = 1; t < 8; ++t) blk64[t] += src[t + 8];
      } else {
        for (int t = 1; t < 8; ++t) blk64[t] += rounded_div(v, src[t + 8] * nq, v.qp);
      }
    }
  }
  int16_t* dst = v.ac_at(k, r, c);
  for (int t = 1; t < 8; ++t) {
    dst[t] = blk64[t << 3];
    dst[8 + t] = blk64[t];
  }
}

__device__ __forceinline__ void clear_intra(Vop& v, int y, int x) {
#pragma unroll 1
  for (int blk = 0; blk < 6; ++blk) {
    int k, r, c;
    block_pos(y, x, blk, &k, &r, &c);
    v.dc_at(k, r, c) = 1024;
    uint4* a = (uint4*)v.ac_at(k, r, c);
    a[0] = a[1] = make_uint4(0, 0, 0, 0);
  }
}

// ff_mpeg4_clean_buffers: the AC values of the blocks from (row - 1, column
// - 1) of the macroblock's first luma block on, 2 rows of luma and 1 of
// chroma in raster order of the padded grid (a resync marker's; rare)
__device__ void clean_buffers(Vop& v, int y, int x) {
  const int lxy = v.b8 + 1 + (2 * y - 1) * v.b8 + 2 * x - 1;
  for (int j = max(lxy, 0); j < lxy + 2 * v.b8 + 1; ++j) {
    int16_t* a = v.ac_at(0, j / v.b8 - 1, j % v.b8 - 1);
    for (int t = 0; t < 16; ++t) a[t] = 0;
  }
  const int cxy = v.mbs + 1 + (y - 1) * v.mbs + x - 1;
  for (int k = 1; k < 3; ++k)
    for (int j = max(cxy, 0); j < cxy + v.mbs + 1; ++j) {
      int16_t* a = v.ac_at(k, j / v.mbs - 1, j % v.mbs - 1);
      for (int t = 0; t < 16; ++t) a[t] = 0;
    }
}

// one block: DC, TCOEF with escapes 1-3, DC and AC prediction; the block's
// levels (raster order) built in place in blk64 (the macroblock's levels in
// shared memory, zeroed)
__device__ __forceinline__ int read_block_levels(Reader& b, const int16_t* lut, const int* tco, const int* maxes,
                                                 const int8_t* scans, Vop& v, int intra, int coded, int y, int x,
                                                 int blk, int use_dc_vlc, int16_t* blk64) {
  int err = OK;
  int i = -1, dir = 0, scale = 0;
  const int8_t* scan = scans;
  if (intra) {
    scale = blk < 4 ? kYDcScale[v.qp] : kCDcScale[v.qp];
    if (use_dc_vlc) {
      int size = vlc(b, lut, blk < 4 ? L_DC_LUM : L_DC_CHROM, &err);
      if (err) return err;
      int level = 0;
      if (size) {
        int val = (int)b.read(size);
        level = (val >> (size - 1)) ? val : val - (1 << size) + 1;
        if (size > 8 && b.read1() != 1) return E_MARKER;
      }
      blk64[0] = (int16_t)pred_dc(v, y, x, blk, level, scale, &dir);
      i = 0;
    } else {
      pred_dc(v, y, x, blk, 0, scale, &dir);
    }
    if (v.ac_pred) scan = scans + (dir == 0 ? 128 : 64);
  }
  if (coded) {
    const int* tab = tco + (intra ? 0 : 1 << TCOEF_BITS);
    const int* lmax = maxes + (intra ? 0 : 256);
    const int* rmax = lmax + 128;
    for (;;) {
      // a code with its sign bit, (last, run + 1, level) in the same entry;
      // past the 64th coefficient is an error (the block is then cleared)
      b.steps++;
      const int e = tab[b.peek(TCOEF_BITS)];
      if (__builtin_expect(e >= 0, 1)) {
        b.skip(e & 31);
        i += e >> 24;
        blk64[scan[i < 63 ? i : 63]] = (int16_t)(e >> 8);
        if (__builtin_expect((e & 32) || i > 63, 0)) {
          if (i > 63) err = E_OVERRUN;
          break;
        }
        continue;
      }
      if (e != T_ESCAPE) {
        err = E_VLC;
        break;
      }
      int last, run, level;
      b.skip(7);
      if (b.read1() == 0) {
        if (!tcoef(b, tab, &last, &run, &level, &err)) break;
        const int sign = level < 0;
        level = (sign ? -level : level) + lmax[last * 64 + run];
        if (sign) level = -level;
      } else if (b.read1() == 0) {
        if (!tcoef(b, tab, &last, &run, &level, &err)) break;
        run += rmax[last * 64 + (level < 0 ? -level : level)] + 1;
      } else {
        last = b.read1();
        run = (int)b.read(6);
        if (b.read1() != 1) { err = E_MARKER; break; }
        level = sext((int)b.read(12), 12);
        if (b.read1() != 1) { err = E_MARKER; break; }
      }
      i += run + 1;
      if (i > 63) { err = E_OVERRUN; break; }
      blk64[scan[i]] = (int16_t)level;
      if (last) break;
    }
    if (err) return err;
  }
  if (intra) {
    if (!use_dc_vlc) blk64[0] = (int16_t)pred_dc(v, y, x, blk, blk64[0], scale, &dir);
    pred_ac(v, y, x, blk, blk64, dir);
  }
  return OK;
}

__device__ __forceinline__ bool is_resync(const Reader& b, int kind, int fcode) {
  const int stuff = 8 - (int)(b.pos() & 7);
  if ((int)b.peek(stuff) != (1 << (stuff - 1)) - 1) return false;
  const int zeros = kind == 0 ? 16 : 15 + fcode;
  return b.size - (b.pos() + stuff) > zeros && b.peek_at(stuff, zeros + 1) == 1;
}

// one macroblock (index) of the VOP into its record (12 int32) and levels
// (6 x 64 int16), both in shared memory and zeroed (a block that fails is
// cleared again); -> the status (OK to go on)
__device__ __forceinline__ int parse_mb(Reader& b, const int16_t* lut, const int* tco, const int* maxes,
                                        const int8_t* scans, Vop& v, int index, int resync, int mb_bits, int* mbr,
                                        int16_t* lvo) {
  const int y = index / v.mbw, x = index - y * v.mbw;
  if (index > 0 && resync && is_resync(b, v.kind, v.fcode)) {
    b.skip(8 - (int)(b.pos() & 7));
    b.skip((v.kind == 0 ? 16 : 15 + v.fcode) + 1);
    if ((int)b.read(mb_bits) != index) return E_PACKET;
    int q = (int)b.read(5);
    if (q) v.qp = q;
    if (b.read1()) {
      while (b.read1()) {
        if (b.pos() > b.size) break;
      }
      if (b.read1() != 1) return E_MARKER;
      b.read(v.time_bits);
      if (b.read1() != 1) return E_MARKER;
      b.read(2);
      b.read(3);
      if (v.kind != 0) b.read(3);
    }
    v.resync_x = x;
    v.resync_y = y;
    v.first_line = 1;
    clean_buffers(v, y, x);
  }
  if (x == v.resync_x && y == v.resync_y + 1) v.first_line = 0;
  int err = OK;
  int mode = MODE_INTRA, dquant = 0, cbpc = 0;
  if (v.kind == 1) {
    for (;;) {
      if (b.read1()) {
        mode = MODE_SKIP;
        break;
      }
      cbpc = vlc(b, lut, L_INTER_MCBPC, &err);
      if (err || cbpc != 20) break;
    }
    if (err) return err;
    if (mode != MODE_SKIP) {
      dquant = cbpc & 8;
      mode = (cbpc & 4) ? MODE_INTRA : ((cbpc & 16) ? MODE_INTER4V : MODE_INTER);
    }
  } else {
    do {
      cbpc = vlc(b, lut, L_INTRA_MCBPC, &err);
    } while (!err && cbpc == 8);
    if (err) return err;
    dquant = cbpc & 4;
  }
  if (mode == MODE_SKIP) {
    mbr[0] = MODE_SKIP;
    mbr[1] = v.qp;
    for (int blk = 0; blk < 4; ++blk) {
      int* m = v.mv_at(2 * y + (blk >> 1), 2 * x + (blk & 1));
      m[0] = m[1] = 0;
    }
    v.q_at(y, x) = v.qp;
    clear_intra(v, y, x);
    return b.pos() > b.size ? E_END : OK;
  }
  int cbpy, use_dc_vlc = 0;
  if (mode == MODE_INTRA) {
    v.ac_pred = b.read1();
    cbpy = vlc(b, lut, L_CBPY, &err);
    if (err) return err;
    use_dc_vlc = v.qp < v.dc_thr;
    if (dquant) v.qp = min(31, max(1, v.qp + kQuantTab[b.read(2)]));
  } else {
    v.ac_pred = 0;
    cbpy = vlc(b, lut, L_CBPY, &err) ^ 15;
    if (err) return err;
    if (dquant) v.qp = min(31, max(1, v.qp + kQuantTab[b.read(2)]));
  }
  const int cbp = (cbpc & 3) | (cbpy << 2);
  mbr[0] = mode;
  mbr[1] = v.qp;
  mbr[2] = cbp;
  mbr[3] = v.ac_pred;
  v.q_at(y, x) = v.qp;
  if (mode == MODE_INTRA) {
    for (int blk = 0; blk < 4; ++blk) {
      int* m = v.mv_at(2 * y + (blk >> 1), 2 * x + (blk & 1));
      m[0] = m[1] = 0;
    }
  } else {
    // 1MV: one vector from block 0's prediction for all four; 4MV: one a block
    const int nmv = mode == MODE_INTER4V ? 4 : 1;
#pragma unroll 1
    for (int blk = 0; blk < nmv; ++blk) {
      int px, py;
      pred_mv(v, y, x, blk, &px, &py);
      const int mx = read_mv(b, lut, px, v.fcode, &err);
      const int my = read_mv(b, lut, py, v.fcode, &err);
      if (err) return err;
      for (int j = blk; j < (nmv == 1 ? 4 : blk + 1); ++j) {
        mbr[4 + 2 * j] = mx;
        mbr[5 + 2 * j] = my;
        int* m = v.mv_at(2 * y + (j >> 1), 2 * x + (j & 1));
        m[0] = mx;
        m[1] = my;
      }
    }
  }
  const int intra = mode == MODE_INTRA;
  if (!intra) clear_intra(v, y, x);
#pragma unroll 1
  for (int blk = 0; blk < 6; ++blk) {
    int16_t* blk64 = lvo + blk * 64;
    err = read_block_levels(b, lut, tco, maxes, scans, v, intra, (cbp >> (5 - blk)) & 1, y, x, blk,
                            intra && use_dc_vlc, blk64);
    if (err) {  // a block that fails leaves no levels
      for (int j = 0; j < 64; ++j) blk64[j] = 0;
      return err;
    }
  }
  return b.pos() > b.size ? E_END : OK;
}

// lanes other than 0 stage the next bytes of the VOP into L1 ahead of lane
// 0's reader
__device__ __forceinline__ void prefetch_l1(const void* p) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
#else
  (void)p;
#endif
}

// the parse kernel's dynamic shared memory, in bytes from its start
struct ParseLayout {
  int lut, tco, maxes, scans, magic, dc_l, dc_c, ac_l, ac_c, mv, q, rec, levels, info, bytes;
  __host__ __device__ ParseLayout(int mbw) {
    const int ring_l = 3 * (2 * mbw + 1), ring_c = 2 * (mbw + 1);
    lut = 0;                                  // N_LUT int16
    tco = lut + 2 * N_LUT;                    // N_TCOEF int32
    maxes = tco + 4 * N_TCOEF;                // N_MAXES int32
    scans = maxes + 4 * N_MAXES;              // 3 x 64 int8
    magic = scans + 192;                      // 64 uint32
    dc_l = magic + 256;                       // ring_l int32
    dc_c = dc_l + 4 * ring_l;                 // 2 x ring_c int32
    ac_l = (dc_c + 8 * ring_c + 15) & ~15;    // ring_l x 16 int16
    ac_c = ac_l + 32 * ring_l;                // 2 x ring_c x 16 int16
    mv = ac_c + 64 * ring_c;                  // ring_l int32 pairs
    q = mv + 8 * ring_l;                      // 2 x mbw int32
    rec = (q + 8 * mbw + 15) & ~15;           // 2 x 12 int32: a macroblock's record, double-buffered
    levels = rec + 2 * 48;                    // 2 x 6 x 64 int16: its levels
    info = levels + 2 * 768;                  // 2 x 4 int32: what each step hands the warp
    bytes = info + 32;
  }
};

// mp4v_parse_kernel: a warp per VOP (grid-stride over the batch's VOPs).
// Lane 0 runs the VOP's chain of VLC symbols a macroblock a step: the
// bitstream through a register window, the VLC tables (int16) and the DC,
// AC, MV and quantiser prediction state of the rows prediction reads (rings)
// in shared memory, the macroblock's record and levels built in shared
// memory. After each step the warp stores them in one coalesced pass
// (double-buffered, so lane 0 parses the next macroblock meanwhile) and the
// other lanes prefetch the bytes ahead. Every loop over lanes strides by
// blockDim.x (1 to 32 threads).
__global__ void mp4v_parse_kernel(const uint8_t* bits, const int* vops, int nvop, const int16_t* lut, const int* tco,
                                  const int* maxes, int mbw, int mbh, int time_bits, int resync, int* mb_out,
                                  int16_t* levels_out, int* status, int* steps) {
  DYNAMIC_SHARED(smem);
  const ParseLayout L(mbw);
  const int lane = threadIdx.x, nt = blockDim.x;
  const unsigned warp = nt >= 32 ? 0xFFFFFFFFu : (1u << nt) - 1;  // the block's lanes
  for (int i = lane; i < N_LUT / 2; i += nt) ((int*)(smem + L.lut))[i] = ((const int*)lut)[i];
  for (int i = lane; i < N_TCOEF; i += nt) ((int*)(smem + L.tco))[i] = tco[i];
  for (int i = lane; i < N_MAXES; i += nt) ((int*)(smem + L.maxes))[i] = maxes[i];
  for (int i = lane; i < 2 * (48 + 768) / 4; i += nt) ((int*)(smem + L.rec))[i] = 0;  // records and levels
  const int16_t* lut_s = (const int16_t*)(smem + L.lut);
  const int* tco_s = (const int*)(smem + L.tco);
  const int* maxes_s = (const int*)(smem + L.maxes);
  int8_t* scans_s = (int8_t*)(smem + L.scans);  // zigzag, alternate horizontal, alternate vertical
  uint32_t* magic_s = (uint32_t*)(smem + L.magic);
  for (int i = lane; i < 64; i += nt) {
    magic_s[i] = i >= 2 ? 0xFFFFFFFFu / i + 1 : 0;
    scans_s[i] = kZigzag[i];
    scans_s[64 + i] = kAltH[i];
    scans_s[128 + i] = kAltV[i];
  }
  const int ring_l = 3 * (2 * mbw + 1), ring_c = 2 * (mbw + 1);
  Vop v;
  v.mbw = mbw;
  v.mbh = mbh;
  v.b8 = 2 * mbw + 1;
  v.mbs = mbw + 1;
  v.time_bits = time_bits;
  v.dc_l = (int*)(smem + L.dc_l);
  v.dc_c = (int*)(smem + L.dc_c);
  v.ac_l = (int16_t*)(smem + L.ac_l);
  v.ac_c = (int16_t*)(smem + L.ac_c);
  v.mv = (int*)(smem + L.mv);
  v.qtab = (int*)(smem + L.q);
  v.magic = magic_s;
  const int n = mbw * mbh;
  const int mb_bits = n > 1 ? 32 - __clz(n - 1) : 1;
  for (int vi = blockIdx.x; vi < nvop; vi += gridDim.x) {
    const int* row = vops + vi * V_FIELDS;
    const uint8_t* data = bits + row[V_OFFSET];
    const int nbytes = row[V_BYTES];
    __syncwarp(warp);  // the tables in place; the previous VOP's last macroblock stored
    // the rings as FFmpeg's fresh tables: DC 1024, AC and MVs 0
    for (int i = lane; i < ring_l + 2 * ring_c; i += nt) ((int*)(smem + L.dc_l))[i] = 1024;
    for (int i = lane; i < (L.q - L.ac_l) / 4; i += nt) ((int*)(smem + L.ac_l))[i] = 0;
    __syncwarp(warp);
    Reader b;
    int err = OK;
    if (lane == 0) {
      b.start(data, row[V_BIT], nbytes);
      v.kind = row[V_KIND];
      v.fcode = row[V_FCODE];
      v.dc_thr = row[V_DC_THR];
      v.qp = row[V_QP];
      v.resync_x = v.resync_y = 0;
      v.first_line = 1;
      v.ac_pred = 0;
    }
    int* mbo = mb_out + (long)vi * n * 12;
    int16_t* lvo = levels_out + (long)vi * n * 6 * 64;
    for (int index = 0;; ++index) {
      int* rec = (int*)(smem + L.rec) + (index & 1) * 12;
      int16_t* lev = (int16_t*)(smem + L.levels) + (index & 1) * 384;
      int* in = (int*)(smem + L.info) + (index & 1) * 4;
      if (lane == 0) {
        if (index < n) err = parse_mb(b, lut_s, tco_s, maxes_s, scans_s, v, index, resync, mb_bits, rec, lev);
        in[0] = index < n ? index : -1;
        in[1] = index + 1 >= n || err != OK;
        in[2] = b.pos() >> 3;
        if (in[1]) {
          status[vi * 2] = err;
          status[vi * 2 + 1] = b.pos();
          if (steps) steps[vi] = b.steps;
        }
      }
      __syncwarp(warp);
      const int m = in[0], done = in[1];
      if (m >= 0) {
        int* dst = mbo + (long)m * 12;
        for (int i = lane; i < 12; i += nt) {
          dst[i] = rec[i];
          rec[i] = 0;
        }
        int* ldst = (int*)(lvo + (long)m * 384);
        for (int i = lane; i < 192; i += nt) {
          ldst[i] = ((int*)lev)[i];
          ((int*)lev)[i] = 0;
        }
      }
      if (done) break;
      if (lane > 0) prefetch_l1(data + max(0, min(in[2] + 128 * lane, nbytes - 1)));
    }
  }
}

// ------------------------------------------------------------------ recon

constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867, W7 = 4520;

struct ReconArgs {
  int mbw, mbh, width, height, h_edge, v_edge, mpeg_quant, rounding;
  const int* intra_matrix;  // 64, raster
  const int* inter_matrix;
};

__device__ __forceinline__ int wrap16(int x) { return (int)(int16_t)x; }
__device__ __forceinline__ int sat16(int x) { return min(max(x, -32768), 32767); }

// 8 values -> 8 outputs of the simple IDCT's butterfly, in unsigned
// arithmetic as FFmpeg's SUINT wraps; a0 holds the DC term
__device__ __forceinline__ void butterfly(const int* xs, unsigned a0, unsigned* out) {
  unsigned x[8];
  for (int k = 0; k < 8; ++k) x[k] = (unsigned)xs[k];
  const unsigned w1 = W1, w2 = W2, w3 = W3, w4 = W4, w5 = W5, w6 = W6, w7 = W7;
  unsigned a1 = a0, a2 = a0, a3 = a0;
  a0 += w2 * x[2] + w4 * x[4] + w6 * x[6];
  a1 += w6 * x[2] - w4 * x[4] - w2 * x[6];
  a2 += -w6 * x[2] - w4 * x[4] + w2 * x[6];
  a3 += -w2 * x[2] + w4 * x[4] - w6 * x[6];
  const unsigned b0 = w1 * x[1] + w3 * x[3] + w5 * x[5] + w7 * x[7];
  const unsigned b1 = w3 * x[1] - w7 * x[3] - w1 * x[5] - w5 * x[7];
  const unsigned b2 = w5 * x[1] - w1 * x[3] + w7 * x[5] + w3 * x[7];
  const unsigned b3 = w7 * x[1] - w5 * x[3] + w3 * x[5] - w1 * x[7];
  out[0] = a0 + b0;
  out[1] = a1 + b1;
  out[2] = a2 + b2;
  out[3] = a3 + b3;
  out[4] = a3 - b3;
  out[5] = a2 - b2;
  out[6] = a1 - b1;
  out[7] = a0 - b0;
}

__device__ __forceinline__ int sample(const uint8_t* p, int stride, int y, int x, int hmax, int wmax) {
  y = min(max(y, 0), hmax - 1);
  x = min(max(x, 0), wmax - 1);
  return p[y * stride + x];
}

// the 8x8 prediction at (sy, sx) with half-pel dxy, coordinates clamped to
// the edge; with rounding type 1 an 8-wide operation (approx: chroma and
// 4MV luma) averages x2 / y2 as FFmpeg's x86 put_no_rnd_pixels8_x2 / _y2
// (the left, or odd row's, sample less 1 saturated at 0, then pavgb), a
// 16x16 one exactly
__device__ void half_pel(const uint8_t* ref, int stride, int sy, int sx, int dxy, int rounding, int approx,
                         int hmax, int wmax, int* pred) {
  for (int i = 0; i < 8; ++i) {
    for (int j = 0; j < 8; ++j) {
      const int a = sample(ref, stride, sy + i, sx + j, hmax, wmax);
      const int b = sample(ref, stride, sy + i, sx + j + 1, hmax, wmax);
      const int c = sample(ref, stride, sy + i + 1, sx + j, hmax, wmax);
      const int d = sample(ref, stride, sy + i + 1, sx + j + 1, hmax, wmax);
      int p;
      if (dxy == 0) {
        p = a;
      } else if (dxy == 1) {
        if (!rounding) p = (a + b + 1) >> 1;
        else p = approx ? (max(a - 1, 0) + b + 1) >> 1 : (a + b) >> 1;
      } else if (dxy == 2) {
        if (!rounding) p = (a + c + 1) >> 1;
        else if (!approx) p = (a + c) >> 1;
        else p = (i & 1) ? (max(a - 1, 0) + c + 1) >> 1 : (a + max(c - 1, 0) + 1) >> 1;
      } else {
        p = (a + b + c + d + 2 - rounding) >> 2;
      }
      pred[i * 8 + j] = p;
    }
  }
}

__global__ void mp4v_recon_kernel(const int* mb, const int16_t* levels, ReconArgs r, const uint8_t* ref_y,
                                  const uint8_t* ref_u, const uint8_t* ref_v, uint8_t* out_y, uint8_t* out_u,
                                  uint8_t* out_v) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = r.mbw * r.mbh;
  if (t >= n * 6) return;
  const int mbi = t / 6, blk = t % 6;
  const int my = mbi / r.mbw, mx = mbi % r.mbw;
  const int* m = mb + mbi * 12;
  const int mode = m[0], qp = m[1];
  const int intra = mode == MODE_INTRA;
  // dequantisation
  int c[64];
  const int16_t* lv = levels + (long)t * 64;
  if (r.mpeg_quant) {
    int sum = 0;
    for (int j = 0; j < 64; ++j) {
      const int l = lv[j];
      if (!l) {
        c[j] = 0;
        continue;
      }
      const int mag = abs(l);
      int v = intra ? (mag * (2 * qp) * r.intra_matrix[j]) >> 4
                    : ((2 * mag + 1) * (2 * qp) * r.inter_matrix[j]) >> 5;
      v = wrap16(l < 0 ? -v : v);
      c[j] = v;
      sum += v;
    }
    if (!intra && (sum & 1) == 0) c[63] ^= 1;
  } else {
    const int qadd = (qp - 1) | 1;
    for (int j = 0; j < 64; ++j) {
      const int l = lv[j];
      if (!l) {
        c[j] = 0;
        continue;
      }
      const int v = abs(l) * (2 * qp) + qadd;
      const int s = l < 0 ? -v : v;
      c[j] = intra ? wrap16(s) : min(max(s, -2048), 2047);
    }
  }
  if (intra) c[0] = wrap16(lv[0] * (blk < 4 ? kYDcScale[qp] : kCDcScale[qp]));
  // IDCT rows (int16 store, DC-only shortcut), then columns
  for (int i = 0; i < 8; ++i) {
    int* row = c + 8 * i;
    bool dc_only = true;
    for (int j = 1; j < 8; ++j) dc_only &= row[j] == 0;
    if (dc_only) {
      const int v = sat16(row[0] * 8);
      for (int j = 0; j < 8; ++j) row[j] = v;
      continue;
    }
    unsigned out[8];
    butterfly(row, (unsigned)W4 * (unsigned)row[0] + (1u << 10), out);
    for (int j = 0; j < 8; ++j) row[j] = sat16((int)out[j] >> 11);
  }
  int res[64];
  for (int j = 0; j < 8; ++j) {
    int col[8];
    for (int i = 0; i < 8; ++i) col[i] = c[8 * i + j];
    unsigned out[8];
    butterfly(col, (unsigned)W4 * (unsigned)wrap16(col[0] + 32), out);
    for (int i = 0; i < 8; ++i) res[8 * i + j] = (int)out[i] >> 20;
  }
  // prediction
  int pred[64];
  const int luma = blk < 4;
  if (intra || ref_y == nullptr) {
    for (int j = 0; j < 64; ++j) pred[j] = 0;
  } else {
    const int four = mode == MODE_INTER4V;
    if (luma) {
      const int mvx = mode == MODE_SKIP ? 0 : m[4 + 2 * blk], mvy = mode == MODE_SKIP ? 0 : m[5 + 2 * blk];
      int sx = mx * 16 + (blk & 1) * 8 + (mvx >> 1);
      int sy = my * 16 + (blk >> 1) * 8 + (mvy >> 1);
      int dxy = (mvx & 1) | ((mvy & 1) << 1);
      if (four) {
        sx = min(max(sx, -16), r.width);
        sy = min(max(sy, -16), r.height);
        dxy = (sx != r.width ? (mvx & 1) : 0) | (sy != r.height ? (mvy & 1) << 1 : 0);
      }
      half_pel(ref_y, r.mbw * 16, sy, sx, dxy, r.rounding, four, r.v_edge, r.h_edge, pred);
    } else {
      int cmx, cmy;
      if (four) {
        int s_x = 0, s_y = 0;
        for (int k = 0; k < 4; ++k) {
          s_x += m[4 + 2 * k];
          s_y += m[5 + 2 * k];
        }
        cmx = kChromaRound[s_x & 15] + ((s_x >> 3) & ~1);
        cmy = kChromaRound[s_y & 15] + ((s_y >> 3) & ~1);
      } else {
        const int mvx = mode == MODE_SKIP ? 0 : m[4], mvy = mode == MODE_SKIP ? 0 : m[5];
        cmx = (mvx >> 1) | (mvx & 1);
        cmy = (mvy >> 1) | (mvy & 1);
      }
      int dxy = (cmx & 1) | ((cmy & 1) << 1);
      int sx = mx * 8 + (cmx >> 1), sy = my * 8 + (cmy >> 1);
      if (four) {
        sx = min(max(sx, -8), r.width >> 1);
        sy = min(max(sy, -8), r.height >> 1);
        if (sx == (r.width >> 1)) dxy &= ~1;
        if (sy == (r.height >> 1)) dxy &= ~2;
      }
      half_pel(blk == 4 ? ref_u : ref_v, r.mbw * 8, sy, sx, dxy, r.rounding, 1, r.v_edge >> 1, r.h_edge >> 1,
               pred);
    }
  }
  // add, clip, store
  uint8_t* dst;
  int stride;
  if (luma) {
    stride = r.mbw * 16;
    dst = out_y + (my * 16 + (blk >> 1) * 8) * stride + mx * 16 + (blk & 1) * 8;
  } else {
    stride = r.mbw * 8;
    dst = (blk == 4 ? out_u : out_v) + my * 8 * stride + mx * 8;
  }
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) dst[i * stride + j] = (uint8_t)min(max(pred[i * 8 + j] + res[i * 8 + j], 0), 255);
}

// ------------------------------------------------------------------ colour

struct Colour {
  int yc, vr, ub, vg, ug, yo;
};

__device__ __forceinline__ int pmulhw(int a, int b) { return (a * b) >> 16; }

__global__ void yuv420_to_bgr_kernel(const uint8_t* y, const uint8_t* u, const uint8_t* v, int ystride,
                                     int cstride, int height, int width, Colour k, uint8_t* out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;
  if (x >= width || row >= height) return;
  const int luma = pmulhw(y[row * ystride + x] * 8 - k.yo, k.yc);
  const int cu = (u[(row >> 1) * cstride + (x >> 1)] - 128) * 8;
  const int cv = (v[(row >> 1) * cstride + (x >> 1)] - 128) * 8;
  const int b = luma + pmulhw(cu, k.ub);
  const int g = luma + (pmulhw(cu, k.ug) + pmulhw(cv, k.vg));
  const int r = luma + pmulhw(cv, k.vr);
  uint8_t* o = out + ((long)row * width + x) * 3;
  o[0] = (uint8_t)min(max(b, 0), 255);
  o[1] = (uint8_t)min(max(g, 0), 255);
  o[2] = (uint8_t)min(max(r, 0), 255);
}

}  // namespace

extern "C" {

// steps: null, or an int32 a VOP taking its chain's steps (VLC symbols)
int dspnet_mp4v_parse(const void* bits, const void* vops, int nvop, const void* lut, const void* tco,
                      const void* maxes, int mbw, int mbh, int time_bits, int resync, void* mb_out, void* levels_out,
                      void* status, void* steps, void* stream) {
  if (nvop <= 0) return 0;
  const ParseLayout L(mbw);
  int err = static_cast<int>(
      cudaFuncSetAttribute(mp4v_parse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes));
  if (err) return err;
  // a block per VOP: the VOPs' serial chains diverge from the first symbol,
  // so VOPs sharing a warp would run one after another
  MP4V_LAUNCH(mp4v_parse_kernel, nvop < MP4V_MAX_BLOCKS ? nvop : MP4V_MAX_BLOCKS, MP4V_PARSE_THREADS, L.bytes,
              static_cast<cudaStream_t>(stream))(
      static_cast<const uint8_t*>(bits), static_cast<const int*>(vops), nvop, static_cast<const int16_t*>(lut),
      static_cast<const int*>(tco), static_cast<const int*>(maxes), mbw, mbh, time_bits, resync,
      static_cast<int*>(mb_out), static_cast<int16_t*>(levels_out), static_cast<int*>(status),
      static_cast<int*>(steps));
  return static_cast<int>(cudaGetLastError());
}

int dspnet_mp4v_recon(const void* mb, const void* levels, int mbw, int mbh, int width, int height, int h_edge,
                      int v_edge, int mpeg_quant, int rounding, const void* intra_matrix, const void* inter_matrix,
                      const void* ref_y, const void* ref_u, const void* ref_v, void* out_y, void* out_u,
                      void* out_v, void* stream) {
  ReconArgs r{mbw, mbh, width, height, h_edge, v_edge, mpeg_quant, rounding,
              static_cast<const int*>(intra_matrix), static_cast<const int*>(inter_matrix)};
  const int n = mbw * mbh * 6;
  const int threads = 128 < MP4V_MAX_THREADS ? 128 : MP4V_MAX_THREADS;
  MP4V_LAUNCH(mp4v_recon_kernel, (n + threads - 1) / threads, threads, 0, static_cast<cudaStream_t>(stream))(
      static_cast<const int*>(mb), static_cast<const int16_t*>(levels), r, static_cast<const uint8_t*>(ref_y),
      static_cast<const uint8_t*>(ref_u), static_cast<const uint8_t*>(ref_v), static_cast<uint8_t*>(out_y),
      static_cast<uint8_t*>(out_u), static_cast<uint8_t*>(out_v));
  return static_cast<int>(cudaGetLastError());
}

int dspnet_yuv420_to_bgr(const void* y, const void* u, const void* v, int ystride, int cstride, int height,
                         int width, const int* coef, void* out, void* stream) {
  Colour k{coef[0], coef[1], coef[2], coef[3], coef[4], coef[5]};
  const int threads = 256 < MP4V_MAX_THREADS ? 256 : MP4V_MAX_THREADS;
  dim3 grid((width + threads - 1) / threads, height);
  MP4V_LAUNCH(yuv420_to_bgr_kernel, grid, threads, 0, static_cast<cudaStream_t>(stream))(
      static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(u), static_cast<const uint8_t*>(v), ystride,
      cstride, height, width, k, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* dspnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
