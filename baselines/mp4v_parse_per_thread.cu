// The MPEG-4 Part 2 entropy parse kernel as it stood before its redesign for
// Hopper, kept on no path as a yardstick: chip_smoke.py builds this file
// beside dspnet_torch/csrc/mpeg4.cu and times both on the same inputs
// (phase 20). Same entry point, tables and layouts as its wrapper of the
// time passed, the per-VOP scratch region included (allocated and filled by
// chip_smoke.py as the wrapper did).
//
// mp4v_parse_kernel: one thread per VOP (a block each), a batch of VOPs in
// one launch. Each lookup reads eight bytes of the bitstream and a 12-bit
// table entry from device memory; the DC, AC and MV prediction state of the
// whole VOP lives in device memory (FFmpeg's layouts).

#include <cuda_runtime.h>
#include <stdint.h>

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

// ------------------------------------------------------------------ parse

struct Reader {
  const uint8_t* buf;
  long pos;
  long size;  // bits

  __device__ uint32_t peek(int n) const {
    const uint8_t* p = buf + (pos >> 3);
    uint64_t v = 0;
    for (int i = 0; i < 8; ++i) v = (v << 8) | p[i];
    return (uint32_t)((v << (pos & 7)) >> (64 - n));
  }
  __device__ uint32_t read(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    pos += n;
    return v;
  }
  __device__ int read1() { return (int)read(1); }
};

struct Tables {
  const int* lut;    // 8 x 4096: symbol << 8 | length, -1 where no code starts
  const int* rll;    // 2 x 102: last << 16 | run << 8 | level (intra, inter)
  const int* maxes;  // intra lmax[2][64], intra rmax[2][64], inter lmax, inter rmax
};

__device__ __forceinline__ int vlc(Reader& b, const Tables& t, int table, int* err) {
  int e = t.lut[table * (1 << LUT_BITS) + b.peek(LUT_BITS)];
  if (e < 0) {
    *err = E_VLC;
    return 0;
  }
  b.pos += e & 0xFF;
  return e >> 8;
}

__device__ __forceinline__ int mid3(int a, int b, int c) { return max(min(a, b), min(max(a, b), c)); }

__device__ __forceinline__ int sext(int v, int bits) {
  v &= (1 << bits) - 1;
  return (v >> (bits - 1)) ? v - (1 << bits) : v;
}

struct Vop {
  // geometry
  int mbw, mbh, b8, mbs, kind, fcode, dc_thr, time_bits;
  // scratch (this VOP's own)
  int* dc[3];
  int16_t* ac[3];
  int* mv;  // pairs
  int* qtab;
  // state
  int qp, resync_x, resync_y, first_line, ac_pred;
};

__device__ __forceinline__ void block_pos(const Vop& v, int y, int x, int blk, int* k, int* i, int* wrap) {
  if (blk < 4) {
    *k = 0;
    *i = v.b8 * (2 * y + (blk >> 1) + 1) + 2 * x + (blk & 1) + 1;
    *wrap = v.b8;
  } else {
    *k = blk - 3;
    *i = v.mbs * (y + 1) + x + 1;
    *wrap = v.mbs;
  }
}

__device__ __forceinline__ int mv_index(const Vop& v, int y, int x, int blk) {
  return v.b8 * (2 * y + (blk >> 1) + 1) + 2 * x + (blk & 1);
}

// ff_h263_pred_motion with FFmpeg's first-slice-line rules
__device__ void pred_mv(Vop& v, int y, int x, int blk, int* px, int* py) {
  const int i = mv_index(v, y, x, blk);
  int* A = v.mv + 2 * (i - 1);
  const int off = blk == 0 ? 2 : (blk == 3 ? -1 : 1);
  if (v.first_line && blk < 3) {
    if (blk == 0) {
      if (x == v.resync_x) {
        *px = *py = 0;
      } else if (x + 1 == v.resync_x) {
        const int* C = v.mv + 2 * (i + off - v.b8);
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
        const int* C = v.mv + 2 * (i + off - v.b8);
        *px = mid3(A[0], 0, C[0]);
        *py = mid3(A[1], 0, C[1]);
      } else {
        *px = A[0];
        *py = A[1];
      }
      return;
    }
    const int* B = v.mv + 2 * (i - v.b8);
    const int* C = v.mv + 2 * (i + off - v.b8);
    if (x == v.resync_x) A[0] = A[1] = 0;
    *px = mid3(A[0], B[0], C[0]);
    *py = mid3(A[1], B[1], C[1]);
    return;
  }
  const int* B = v.mv + 2 * (i - v.b8);
  const int* C = v.mv + 2 * (i + off - v.b8);
  *px = mid3(A[0], B[0], C[0]);
  *py = mid3(A[1], B[1], C[1]);
}

__device__ int read_mv(Reader& b, const Tables& t, int pred, int fcode, int* err) {
  int code = vlc(b, t, L_MV, err);
  if (code == 0) return pred;
  int sign = b.read1();
  int val = code;
  int shift = fcode - 1;
  if (shift) val = (((val - 1) << shift) | (int)b.read(shift)) + 1;
  if (sign) val = -val;
  return sext(val + pred, 5 + fcode);
}

__device__ int pred_dc(Vop& v, int y, int x, int blk, int level, int scale, int* dir) {
  int k, i, wrap;
  block_pos(v, y, x, blk, &k, &i, &wrap);
  int* d = v.dc[k];
  int a = d[i - 1], bb = d[i - 1 - wrap], c = d[i - wrap];
  if (v.first_line && blk != 3) {
    if (blk != 2) bb = c = 1024;
    if (blk != 1 && x == v.resync_x) bb = a = 1024;
  }
  if (x == v.resync_x && y == v.resync_y + 1 && (blk == 0 || blk == 4 || blk == 5)) bb = 1024;
  int pred;
  if (abs(a - bb) < abs(bb - c)) {
    pred = c;
    *dir = 1;
  } else {
    pred = a;
    *dir = 0;
  }
  level += (pred + (scale >> 1)) / scale;
  int val = level * scale;
  if (val & ~2047) val = val < 0 ? 0 : 2047;
  d[i] = val;
  return level;
}

__device__ __forceinline__ int rounded_div(int a, int b) {
  return a > 0 ? (a + (b >> 1)) / b : -((-a + (b >> 1)) / b);
}

__device__ void pred_ac(Vop& v, int y, int x, int blk, int16_t* blk64, int dir) {
  int k, i, wrap;
  block_pos(v, y, x, blk, &k, &i, &wrap);
  int16_t* acv = v.ac[k];
  if (v.ac_pred) {
    if (dir == 0) {
      const int16_t* src = acv + 16 * (i - 1);
      const int nq = x > 0 ? v.qtab[y * v.mbw + x - 1] : v.qp;
      if (x == 0 || v.qp == nq || blk == 1 || blk == 3) {
        for (int t = 1; t < 8; ++t) blk64[t << 3] += src[t];
      } else {
        for (int t = 1; t < 8; ++t) blk64[t << 3] += rounded_div(src[t] * nq, v.qp);
      }
    } else {
      const int16_t* src = acv + 16 * (i - wrap);
      const int nq = y > 0 ? v.qtab[(y - 1) * v.mbw + x] : v.qp;
      if (y == 0 || v.qp == nq || blk == 2 || blk == 3) {
        for (int t = 1; t < 8; ++t) blk64[t] += src[t + 8];
      } else {
        for (int t = 1; t < 8; ++t) blk64[t] += rounded_div(src[t + 8] * nq, v.qp);
      }
    }
  }
  int16_t* dst = acv + 16 * i;
  for (int t = 1; t < 8; ++t) {
    dst[t] = blk64[t << 3];
    dst[8 + t] = blk64[t];
  }
}

__device__ void clear_intra(Vop& v, int y, int x) {
  for (int blk = 0; blk < 6; ++blk) {
    int k, i, wrap;
    block_pos(v, y, x, blk, &k, &i, &wrap);
    v.dc[k][i] = 1024;
    for (int t = 0; t < 16; ++t) v.ac[k][16 * i + t] = 0;
  }
}

__device__ void clean_buffers(Vop& v, int y, int x) {
  const int lxy = v.b8 + 1 + (2 * y - 1) * v.b8 + 2 * x - 1;
  for (int j = max(lxy, 0); j < lxy + 2 * v.b8 + 1; ++j)
    for (int t = 0; t < 16; ++t) v.ac[0][16 * j + t] = 0;
  const int cxy = v.mbs + 1 + (y - 1) * v.mbs + x - 1;
  for (int k = 1; k < 3; ++k)
    for (int j = max(cxy, 0); j < cxy + v.mbs + 1; ++j)
      for (int t = 0; t < 16; ++t) v.ac[k][16 * j + t] = 0;
}

// one block: DC, TCOEF with escapes 1-3, DC and AC prediction; writes the
// block's levels (raster order) into out (zeroed beforehand)
__device__ int read_block(Reader& b, const Tables& t, Vop& v, int intra, int coded, int y, int x, int blk,
                          int use_dc_vlc, int16_t* out) {
  int err = OK;
  int16_t blk64[64];
  for (int j = 0; j < 64; ++j) blk64[j] = 0;
  int i = -1, dir = 0, scale = 0;
  const int8_t* scan = kZigzag;
  if (intra) {
    scale = blk < 4 ? kYDcScale[v.qp] : kCDcScale[v.qp];
    if (use_dc_vlc) {
      int size = vlc(b, t, blk < 4 ? L_DC_LUM : L_DC_CHROM, &err);
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
    if (v.ac_pred) scan = dir == 0 ? kAltV : kAltH;
  }
  if (coded) {
    const int table = intra ? L_INTRA_TCOEF : L_INTER_TCOEF;
    const int* rll = t.rll + (intra ? 0 : 102);
    const int* lmax = t.maxes + (intra ? 0 : 256);
    const int* rmax = lmax + 128;
    for (;;) {
      int sym = vlc(b, t, table, &err);
      if (err) return err;
      int last, run, level;
      if (sym == ESCAPE) {
        if (b.read1() == 0) {
          int s = vlc(b, t, table, &err);
          if (err) return err;
          if (s == ESCAPE) return E_ESCAPE;
          last = rll[s] >> 16, run = (rll[s] >> 8) & 0xFF, level = rll[s] & 0xFF;
          level += lmax[last * 64 + run];
          if (b.read1()) level = -level;
        } else if (b.read1() == 0) {
          int s = vlc(b, t, table, &err);
          if (err) return err;
          if (s == ESCAPE) return E_ESCAPE;
          last = rll[s] >> 16, run = (rll[s] >> 8) & 0xFF, level = rll[s] & 0xFF;
          run += rmax[last * 64 + level] + 1;
          if (b.read1()) level = -level;
        } else {
          last = b.read1();
          run = (int)b.read(6);
          if (b.read1() != 1) return E_MARKER;
          level = sext((int)b.read(12), 12);
          if (b.read1() != 1) return E_MARKER;
        }
      } else {
        last = rll[sym] >> 16, run = (rll[sym] >> 8) & 0xFF, level = rll[sym] & 0xFF;
        if (b.read1()) level = -level;
      }
      i += run + 1;
      if (i > 63) return E_OVERRUN;
      blk64[scan[i]] = (int16_t)level;
      if (last) break;
    }
  }
  if (intra) {
    if (!use_dc_vlc) blk64[0] = (int16_t)pred_dc(v, y, x, blk, blk64[0], scale, &dir);
    pred_ac(v, y, x, blk, blk64, dir);
  }
  for (int j = 0; j < 64; ++j)
    if (blk64[j]) out[j] = blk64[j];
  return OK;
}

__device__ bool is_resync(const Reader& b0, int kind, int fcode) {
  Reader b = b0;
  const int stuff = 8 - (int)(b.pos & 7);
  if ((int)b.peek(stuff) != (1 << (stuff - 1)) - 1) return false;
  b.pos += stuff;
  const int zeros = kind == 0 ? 16 : 15 + fcode;
  return b.size - b.pos > zeros && b.peek(zeros + 1) == 1;
}

__global__ void mp4v_parse_kernel(const uint8_t* bits, const int* vops, int nvop, Tables t, int mbw, int mbh,
                                  int time_bits, int resync, int* scratch, int scratch_words, int* mb_out,
                                  int16_t* levels_out, int* status) {
  const int vi = blockIdx.x * blockDim.x + threadIdx.x;
  if (vi >= nvop) return;
  const int* row = vops + vi * V_FIELDS;
  Reader b{bits + row[V_OFFSET], (long)row[V_BIT], 8L * row[V_BYTES]};
  Vop v;
  v.mbw = mbw;
  v.mbh = mbh;
  v.b8 = 2 * mbw + 1;
  v.mbs = mbw + 1;
  v.kind = row[V_KIND];
  v.fcode = row[V_FCODE];
  v.dc_thr = row[V_DC_THR];
  v.time_bits = time_bits;
  const int n = mbw * mbh;
  const int luma_n = v.b8 * (2 * mbh + 1), chroma_n = v.mbs * (mbh + 1);
  // scratch layout (mpeg4_cuda.scratch_words): dc (int), ac (int16 x 16),
  // mv (int pairs), qtab
  int* base = scratch + (long)vi * scratch_words;
  v.dc[0] = base;
  v.dc[1] = v.dc[0] + luma_n;
  v.dc[2] = v.dc[1] + chroma_n;
  int16_t* acb = reinterpret_cast<int16_t*>(v.dc[2] + chroma_n);
  v.ac[0] = acb;
  v.ac[1] = v.ac[0] + 16 * luma_n;
  v.ac[2] = v.ac[1] + 16 * chroma_n;
  v.mv = reinterpret_cast<int*>(v.ac[2] + 16 * chroma_n);
  v.qtab = v.mv + 2 * (luma_n + 1);
  v.qp = row[V_QP];
  v.resync_x = v.resync_y = 0;
  v.first_line = 1;
  v.ac_pred = 0;
  int* mbo = mb_out + (long)vi * n * 12;
  int16_t* lvo = levels_out + (long)vi * n * 6 * 64;
  const int mb_bits = n > 1 ? 32 - __clz(n - 1) : 1;
  int err = OK;
  for (int index = 0; index < n; ++index) {
    const int y = index / mbw, x = index % mbw;
    if (index > 0 && resync && is_resync(b, v.kind, v.fcode)) {
      b.pos += 8 - (b.pos & 7);
      b.pos += (v.kind == 0 ? 16 : 15 + v.fcode) + 1;
      if ((int)b.read(mb_bits) != index) {
        err = E_PACKET;
        break;
      }
      int q = (int)b.read(5);
      if (q) v.qp = q;
      if (b.read1()) {
        while (b.read1()) {
          if (b.pos > b.size) break;
        }
        if (b.read1() != 1) { err = E_MARKER; break; }
        b.read(time_bits);
        if (b.read1() != 1) { err = E_MARKER; break; }
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
    int* mbr = mbo + index * 12;
    int mode = MODE_INTRA, dquant = 0, cbpc = 0;
    if (v.kind == 1) {
      for (;;) {
        if (b.read1()) {
          mode = MODE_SKIP;
          break;
        }
        cbpc = vlc(b, t, L_INTER_MCBPC, &err);
        if (err || cbpc != 20) break;
      }
      if (err) break;
      if (mode != MODE_SKIP) {
        dquant = cbpc & 8;
        mode = (cbpc & 4) ? MODE_INTRA : ((cbpc & 16) ? MODE_INTER4V : MODE_INTER);
      }
    } else {
      do {
        cbpc = vlc(b, t, L_INTRA_MCBPC, &err);
      } while (!err && cbpc == 8);
      if (err) break;
      dquant = cbpc & 4;
    }
    const int i0 = mv_index(v, y, x, 0);
    if (mode == MODE_SKIP) {
      mbr[0] = MODE_SKIP;
      mbr[1] = v.qp;
      for (int k = 2; k < 12; ++k) mbr[k] = 0;
      for (int blk = 0; blk < 4; ++blk) {
        int* m = v.mv + 2 * (i0 + (blk >> 1) * v.b8 + (blk & 1));
        m[0] = m[1] = 0;
      }
      v.qtab[index] = v.qp;
      clear_intra(v, y, x);
      if (b.pos > b.size) { err = E_END; break; }
      continue;
    }
    int cbpy, use_dc_vlc = 0;
    if (mode == MODE_INTRA) {
      v.ac_pred = b.read1();
      cbpy = vlc(b, t, L_CBPY, &err);
      if (err) break;
      use_dc_vlc = v.qp < v.dc_thr;
      if (dquant) v.qp = min(31, max(1, v.qp + kQuantTab[b.read(2)]));
    } else {
      v.ac_pred = 0;
      cbpy = vlc(b, t, L_CBPY, &err) ^ 15;
      if (err) break;
      if (dquant) v.qp = min(31, max(1, v.qp + kQuantTab[b.read(2)]));
    }
    const int cbp = (cbpc & 3) | (cbpy << 2);
    mbr[0] = mode;
    mbr[1] = v.qp;
    mbr[2] = cbp;
    mbr[3] = v.ac_pred;
    v.qtab[index] = v.qp;
    if (mode == MODE_INTER) {
      int px, py;
      pred_mv(v, y, x, 0, &px, &py);
      const int mx = read_mv(b, t, px, v.fcode, &err);
      const int my = read_mv(b, t, py, v.fcode, &err);
      if (err) break;
      for (int blk = 0; blk < 4; ++blk) {
        mbr[4 + 2 * blk] = mx;
        mbr[5 + 2 * blk] = my;
        int* m = v.mv + 2 * (i0 + (blk >> 1) * v.b8 + (blk & 1));
        m[0] = mx;
        m[1] = my;
      }
    } else if (mode == MODE_INTER4V) {
      for (int blk = 0; blk < 4; ++blk) {
        int px, py;
        pred_mv(v, y, x, blk, &px, &py);
        const int mx = read_mv(b, t, px, v.fcode, &err);
        const int my = read_mv(b, t, py, v.fcode, &err);
        if (err) break;
        mbr[4 + 2 * blk] = mx;
        mbr[5 + 2 * blk] = my;
        int* m = v.mv + 2 * (i0 + (blk >> 1) * v.b8 + (blk & 1));
        m[0] = mx;
        m[1] = my;
      }
      if (err) break;
    } else {
      for (int k = 4; k < 12; ++k) mbr[k] = 0;
      for (int blk = 0; blk < 4; ++blk) {
        int* m = v.mv + 2 * (i0 + (blk >> 1) * v.b8 + (blk & 1));
        m[0] = m[1] = 0;
      }
    }
    const int intra = mode == MODE_INTRA;
    if (!intra) clear_intra(v, y, x);
    for (int blk = 0; blk < 6; ++blk) {
      err = read_block(b, t, v, intra, (cbp >> (5 - blk)) & 1, y, x, blk, intra && use_dc_vlc,
                       lvo + (long)(index * 6 + blk) * 64);
      if (err) break;
    }
    if (err) break;
    if (b.pos > b.size) {
      err = E_END;
      break;
    }
  }
  status[vi * 2] = err;
  status[vi * 2 + 1] = (int)b.pos;
}

}  // namespace

extern "C" {

const char* dspnet_cuda_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int dspnet_mp4v_parse(const void* bits, const void* vops, int nvop, const void* lut, const void* rll,
                      const void* maxes, int mbw, int mbh, int time_bits, int resync, void* scratch,
                      int scratch_words, void* mb_out, void* levels_out, void* status, void* stream) {
  if (nvop <= 0) return 0;
  Tables t{static_cast<const int*>(lut), static_cast<const int*>(rll), static_cast<const int*>(maxes)};
  mp4v_parse_kernel<<<nvop, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bits), static_cast<const int*>(vops), nvop, t, mbw, mbh, time_bits, resync,
      static_cast<int*>(scratch), scratch_words, static_cast<int*>(mb_out), static_cast<int16_t*>(levels_out),
      static_cast<int*>(status));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
