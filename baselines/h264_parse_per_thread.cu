// The H.264 slice-data parse kernel as it stood before its redesign for
// Hopper, kept on no path as a yardstick: chip_smoke.py builds this file
// beside dspnet_torch/csrc/h264.cu and times both on the same inputs (phase
// 23). Same entry point, tables and layouts as the current wrapper
// (dspnet_torch/data/h264_cuda.py) passes.
//
// h264_parse_kernel: a thread block per slice, one thread working, every
// slice of a batch in one launch. The CABAC context states (1024 bytes)
// live in the block's shared memory; everything else is read from and
// written to device memory: the bitstream one byte a bit, the CABAC and
// CAVLC tables (CAVLC codes by a linear scan of (length, code) pairs), and
// the neighbour state of the slice's macroblocks, read back from the
// macroblock table the thread writes.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef H264_LAUNCH
#define H264_LAUNCH(kernel, grid, block, stream) kernel<<<(grid), (block), 0, (stream)>>>
#endif

namespace {

// ---- the constant tables, one int32 array from the host (h264_cuda._host_tables)
constexpr int O_CABAC = 0;                  // [4][1024][2] m, n (idc 0-2, then I)
constexpr int O_LPS = O_CABAC + 8192;       // [64][4]
constexpr int O_MPS = O_LPS + 256;          // [64]
constexpr int O_LPSN = O_MPS + 64;          // [64]
constexpr int O_SIG8 = O_LPSN + 64;         // [64]
constexpr int O_LAST8 = O_SIG8 + 64;        // [64]
constexpr int O_CT_LEN = O_LAST8 + 64;      // [4][17][4]
constexpr int O_CT_BITS = O_CT_LEN + 272;   // [4][17][4]
constexpr int O_CDC_LEN = O_CT_BITS + 272;  // [5][4]
constexpr int O_CDC_BITS = O_CDC_LEN + 20;  // [5][4]
constexpr int O_TZ_LEN = O_CDC_BITS + 20;   // [15][16]
constexpr int O_TZ_BITS = O_TZ_LEN + 240;   // [15][16]
constexpr int O_CTZ_LEN = O_TZ_BITS + 240;  // [3][4]
constexpr int O_CTZ_BITS = O_CTZ_LEN + 12;  // [3][4]
constexpr int O_RUN_LEN = O_CTZ_BITS + 12;  // [7][16]
constexpr int O_RUN_BITS = O_RUN_LEN + 112; // [7][16]
constexpr int O_CBP_INTRA = O_RUN_BITS + 112;
constexpr int O_CBP_INTER = O_CBP_INTRA + 48;
constexpr int O_CBP400 = O_CBP_INTER + 48;  // [inter 16, intra 16]
constexpr int O_ZZ4 = O_CBP400 + 32;
constexpr int O_ZZ8 = O_ZZ4 + 16;
constexpr int O_ALPHA = O_ZZ8 + 64;
constexpr int O_BETA = O_ALPHA + 52;
constexpr int O_TC0 = O_BETA + 52;          // [52][3]
constexpr int O_CQP = O_TC0 + 156;
constexpr int N_TABLES = O_CQP + 52;

// ---- the macroblock table (h264_parse.MB_FIELDS)
enum { F_SLICE, F_TYPE, F_PART, F_PRED, F_SUB, F_T8, F_CBP, F_QP, F_I16, F_CPRED, F_NZ, F_REF0, F_REF1, F_IM0, F_IM1,
       F_MVD };
constexpr int N_FIELDS = F_MVD + 64;
constexpr int N_LEVELS = 408, L_DC = 256, L_CDC = 272, L_CAC = 280;
enum { T_I4, T_I8, T_I16, T_PCM, T_INTER, T_PSKIP, T_BSKIP, T_BDIRECT };
constexpr int SUB_DIRECT = 16;
enum { ST_P = 0, ST_B = 1, ST_I = 2 };

// ---- the parse's slice table (h264_cuda.SLICE_FIELDS) and scratch per macroblock
enum { S_OFFSET, S_BYTES, S_BIT, S_PIC, S_INDEX, S_FIRST, S_TYPE, S_CABAC, S_IDC, S_QP, S_NREF0, S_NREF1, S_T8MODE,
       S_CIP, S_DIRECT8, S_CHROMA, S_MBW, S_MBH, S_FIELDS };
// scratch: luma counts [16], chroma counts [8], DC flags [3], direct flags [4], coded (1)
constexpr int N_SCRATCH = 32;
enum { SC_COUNT = 0, SC_CCOUNT = 16, SC_DC = 24, SC_DIRECT = 27, SC_CODED = 31 };
// parse status codes
enum { E_OK = 0, E_VLC = 1, E_RANGE = 2, E_OVERRUN = 3, E_TRAILING = 5 };

__device__ __forceinline__ int clip3(int lo, int hi, int v) { return v < lo ? lo : (v > hi ? hi : v); }
__device__ __forceinline__ int clip1(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }
__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ int blk_x(int b) { return (b & 1) | ((b >> 1) & 2); }
__device__ __forceinline__ int blk_y(int b) { return ((b >> 1) & 1) | ((b >> 2) & 2); }
__device__ __forceinline__ int blk_at(int y, int x) { return (x & 1) | ((y & 1) << 1) | ((x & 2) << 1) | ((y & 2) << 2); }

// ================================================================== parse

struct Bits {
  const uint8_t* data;
  int64_t pos, end;
  int err;
  __device__ int bit() {
    if (pos >= end) {
      err = E_OVERRUN;
      pos++;
      return 0;
    }
    int b = (data[pos >> 3] >> (7 - (pos & 7))) & 1;
    pos++;
    return b;
  }
  __device__ int u(int n) {
    int v = 0;
    for (int i = 0; i < n; i++) v = (v << 1) | bit();
    return v;
  }
  __device__ int peek16() {
    int v = 0;
    for (int i = 0; i < 16; i++) {
      int64_t p = pos + i;
      v = (v << 1) | (p < end ? (data[p >> 3] >> (7 - (p & 7))) & 1 : 0);
    }
    return v;
  }
  __device__ int ue() {
    int zeros = 0;
    while (bit() == 0) {
      if (++zeros > 31 || err) {
        err = err ? err : E_VLC;
        return 0;
      }
    }
    return (int)((1u << zeros) - 1 + (zeros ? (unsigned)u(zeros) : 0u));
  }
  __device__ int se() {
    int k = ue();
    return (k & 1) ? (k + 1) >> 1 : -(k >> 1);
  }
  // whether data precede the RBSP's stop bit
  __device__ bool more_rbsp_data() const {
    int64_t last = (end >> 3) - 1;
    while (last >= 0 && data[last] == 0) last--;
    if (last < 0) return false;
    int byte = data[last];
    int tz = 0;
    while (!((byte >> tz) & 1)) tz++;
    return pos < last * 8 + 7 - tz;
  }
};

struct Cabac {
  Bits* bs;
  uint8_t* state;
  int range, offset;
  const int* T;
  __device__ void start() {
    range = 510;
    offset = 0;
    for (int i = 0; i < 9; i++) offset = (offset << 1) | nbit();
  }
  __device__ int nbit() {
    if (bs->pos >= bs->end) {
      if (bs->pos >= bs->end + 16) bs->err = E_OVERRUN;
      bs->pos++;
      return 0;
    }
    return bs->bit();
  }
  __device__ int decision(int ctx) {
    int s = state[ctx];
    int p = s >> 1, mps = s & 1, b;
    int lps = T[O_LPS + p * 4 + ((range >> 6) & 3)];
    range -= lps;
    if (offset >= range) {
      b = 1 - mps;
      offset -= range;
      range = lps;
      if (p == 0) mps = 1 - mps;
      state[ctx] = (uint8_t)((T[O_LPSN + p] << 1) | mps);
    } else {
      b = mps;
      state[ctx] = (uint8_t)((T[O_MPS + p] << 1) | mps);
    }
    while (range < 256) {
      range <<= 1;
      offset = (offset << 1) | nbit();
    }
    return b;
  }
  __device__ int bypass() {
    offset = (offset << 1) | nbit();
    if (offset >= range) {
      offset -= range;
      return 1;
    }
    return 0;
  }
  __device__ int terminate() {
    range -= 2;
    if (offset >= range) return 1;
    while (range < 256) {
      range <<= 1;
      offset = (offset << 1) | nbit();
    }
    return 0;
  }
};

struct Parser {
  Bits bs;
  Cabac ce;
  const int* T;
  const int* sl;
  int32_t* tab;   // the picture's macroblock table
  int16_t* lev;   // the picture's levels
  uint8_t* sc;    // the picture's scratch
  int slice_index, first, st, cabac, cip, t8mode, direct8, chroma, mbw, mbh, nmb;
  int nref[2];
  int mb, mbA, mbB, qp, prev_dqp;
  int err;

  __device__ int32_t* row(int m) { return tab + (int64_t)m * N_FIELDS; }
  __device__ uint8_t* scr(int m) { return sc + (int64_t)m * N_SCRATCH; }
  __device__ void fail(int code) {
    if (!err) err = code;
  }
  __device__ int avail(int m) { return m >= first && m < mb; }
  __device__ int nb(int which) {
    int x = mb % mbw, y = mb / mbw, n = -1;
    if (which == 0) n = x > 0 ? mb - 1 : -1;
    else if (which == 1) n = y > 0 ? mb - mbw : -1;
    else if (which == 2) n = (y > 0 && x < mbw - 1) ? mb - mbw + 1 : -1;
    else n = (y > 0 && x > 0) ? mb - mbw - 1 : -1;
    return (n >= 0 && avail(n)) ? n : -1;
  }
  __device__ int type(int m) { return row(m)[F_TYPE]; }
  __device__ int is_intra(int m) { return type(m) <= T_PCM; }
  __device__ int is_skip(int m) { int t = type(m); return t == T_PSKIP || t == T_BSKIP; }
  __device__ void left4(int b, int& m, int& bb) {
    int x = blk_x(b), y = blk_y(b);
    if (x > 0) { m = mb; bb = blk_at(y, x - 1); } else { m = mbA; bb = blk_at(y, 3); }
  }
  __device__ void top4(int b, int& m, int& bb) {
    int x = blk_x(b), y = blk_y(b);
    if (y > 0) { m = mb; bb = blk_at(y - 1, x); } else { m = mbB; bb = blk_at(3, x); }
  }
  __device__ int refidx(int m, int lx, int k) {
    int r = (row(m)[F_REF0 + lx] >> (8 * k)) & 0xFF;
    return r == 0xFF ? -1 : r;
  }
  __device__ void set_ref(int lx, int k, int r) {
    int32_t* rw = row(mb);
    uint32_t v = (uint32_t)rw[F_REF0 + lx];
    v = (v & ~(0xFFu << (8 * k))) | ((uint32_t)(r & 0xFF) << (8 * k));
    rw[F_REF0 + lx] = (int32_t)v;
  }
  __device__ int mvd_of(int m, int lx, int b, int c) { return row(m)[F_MVD + (lx * 16 + b) * 2 + c]; }
  __device__ int imode_of(int m, int b) {
    int32_t w = row(m)[b < 8 ? F_IM0 : F_IM1];
    return (w >> (4 * (b & 7))) & 15;
  }
  __device__ void set_imode(int b, int mode) {
    int32_t* rw = row(mb);
    int f = b < 8 ? F_IM0 : F_IM1;
    uint32_t v = (uint32_t)rw[f];
    v = (v & ~(15u << (4 * (b & 7)))) | ((uint32_t)mode << (4 * (b & 7)));
    rw[f] = (int32_t)v;
  }

  // ---- setting up a macroblock
  __device__ void enter(int m) {
    mb = m;
    mbA = nb(0);
    mbB = nb(1);
    int32_t* rw = row(m);
    for (int i = 0; i < N_FIELDS; i++) rw[i] = 0;
    rw[F_SLICE] = slice_index;
    rw[F_REF0] = rw[F_REF1] = -1;
    uint8_t* s = scr(m);
    for (int i = 0; i < N_SCRATCH; i++) s[i] = 0;
    s[SC_CODED] = 1;
  }

  __device__ void finish() {
    int32_t* rw = row(mb);
    rw[F_QP] = qp;
    int t = rw[F_TYPE], nz = 0;
    const int16_t* lv = lev + (int64_t)mb * N_LEVELS;
    if (t != T_PCM) {
      for (int b = 0; b < 16; b++) {
        int any = 0;
        if (rw[F_T8]) {
          int k = b >> 2;
          for (int i = 0; i < 64 && !any; i++) any = lv[64 * k + i] != 0;
        } else {
          for (int i = 0; i < 16 && !any; i++) any = lv[16 * b + i] != 0;
        }
        if (any) nz |= 1 << b;
      }
    }
    rw[F_NZ] = nz;
  }

  __device__ void skip_mb() {
    int32_t* rw = row(mb);
    rw[F_TYPE] = st == ST_P ? T_PSKIP : T_BSKIP;
    prev_dqp = 0;
    if (st == ST_P) {
      for (int k = 0; k < 4; k++) set_ref(0, k, 0);
    } else {
      for (int k = 0; k < 4; k++) scr(mb)[SC_DIRECT + k] = 1;
    }
    finish();
  }

  // ---- CABAC elements
  __device__ int mb_skip_flag() {
    int inc = (mbA >= 0 && !is_skip(mbA)) + (mbB >= 0 && !is_skip(mbB));
    return ce.decision((st == ST_P ? 11 : 24) + inc);
  }
  __device__ int intra_type(int base, int in_i) {
    int luma, c0, c1, p1, p0;
    if (in_i) {
      int inc = (mbA >= 0 && type(mbA) != T_I4 && type(mbA) != T_I8) + (mbB >= 0 && type(mbB) != T_I4 && type(mbB) != T_I8);
      if (!ce.decision(base + inc)) return 0;
      int s = base + 3;
      luma = s; c0 = s + 1; c1 = s + 2; p1 = s + 3; p0 = s + 4;
    } else {
      if (!ce.decision(base)) return 0;
      int s = base + 1;
      luma = s; c0 = s + 1; c1 = s + 1; p1 = s + 2; p0 = s + 2;
    }
    if (ce.terminate()) return 25;
    int t = 1 + 12 * ce.decision(luma);
    if (ce.decision(c0)) t += 4 + 4 * ce.decision(c1);
    t += 2 * ce.decision(p1);
    t += ce.decision(p0);
    return t;
  }
  __device__ __noinline__ int cabac_mb_type() {
    if (st == ST_I) return intra_type(3, 1);
    if (st == ST_P) {
      if (ce.decision(14) == 0) {
        if (ce.decision(15) == 0) return 3 * ce.decision(16);
        return 2 - ce.decision(17);
      }
      return 5 + intra_type(17, 0);
    }
    int inc = (mbA >= 0 && type(mbA) != T_BSKIP && type(mbA) != T_BDIRECT) +
              (mbB >= 0 && type(mbB) != T_BSKIP && type(mbB) != T_BDIRECT);
    if (!ce.decision(27 + inc)) return 0;
    if (!ce.decision(30)) return 1 + ce.decision(32);
    int bits = ce.decision(31) << 3;
    bits |= ce.decision(32) << 2;
    bits |= ce.decision(32) << 1;
    bits |= ce.decision(32);
    if (bits < 8) return bits + 3;
    if (bits == 13) return 23 + intra_type(32, 0);
    if (bits == 14) return 11;
    if (bits == 15) return 22;
    bits = (bits << 1) | ce.decision(32);
    return bits - 4;
  }
  __device__ int cabac_sub_type() {
    if (st == ST_P) {
      if (ce.decision(21)) return 0;
      if (!ce.decision(22)) return 1;
      return ce.decision(23) ? 2 : 3;
    }
    if (!ce.decision(36)) return 0;
    if (!ce.decision(37)) return 1 + ce.decision(39);
    int t = 3;
    if (ce.decision(38)) {
      if (ce.decision(39)) return 11 + ce.decision(39);
      t += 4;
    }
    t += 2 * ce.decision(39);
    t += ce.decision(39);
    return t;
  }
  __device__ int ref_cond(int m, int b, int lx) {
    if (m < 0 || is_skip(m) || is_intra(m) || scr(m)[SC_DIRECT + (b >> 2)]) return 0;
    return refidx(m, lx, b >> 2) > 0;
  }
  __device__ int cabac_ref(int lx, int blk) {
    int ma, ba, mbb, bb;
    left4(blk, ma, ba);
    top4(blk, mbb, bb);
    int inc = ref_cond(ma, ba, lx) + 2 * ref_cond(mbb, bb, lx);
    int ref = 0;
    while (ce.decision(54 + inc)) {
      ref++;
      inc = (inc >> 2) + 4;
      if (ref >= 32) {
        fail(E_RANGE);
        return 0;
      }
    }
    return ref;
  }
  __device__ __noinline__ int cabac_mvd(int lx, int blk, int comp) {
    int ma, ba, mbb, bb;
    left4(blk, ma, ba);
    top4(blk, mbb, bb);
    int s = (ma >= 0 ? iabs(mvd_of(ma, lx, ba, comp)) : 0) + (mbb >= 0 ? iabs(mvd_of(mbb, lx, bb, comp)) : 0);
    int base = comp == 0 ? 40 : 47;
    int inc = s < 3 ? 0 : (s <= 32 ? 1 : 2);
    if (!ce.decision(base + inc)) return 0;
    int m = 1, ctx = base + 3;
    while (m < 9 && ce.decision(ctx)) {
      if (m < 4) ctx++;
      m++;
    }
    if (m >= 9) {
      int k = 3;
      while (ce.bypass()) {
        m += 1 << k;
        if (++k > 24) {
          fail(E_RANGE);
          return 0;
        }
      }
      while (k--) m += ce.bypass() << k;
    }
    return ce.bypass() ? -m : m;
  }
  __device__ int luma_bit(int m, int k) {
    if (m < 0 || type(m) == T_PCM) return 1;
    return (row(m)[F_CBP] >> k) & 1;
  }
  __device__ int chroma_of(int m) {
    if (m < 0) return 0;
    if (type(m) == T_PCM) return 2;
    return row(m)[F_CBP] >> 4;
  }
  __device__ __noinline__ int cabac_cbp() {
    int cbp = 0;
    for (int k = 0; k < 4; k++) {
      int x = k & 1, y = k >> 1;
      int ba = x ? (cbp >> (k - 1)) & 1 : luma_bit(mbA, k + 1);
      int bb = y ? (cbp >> (k - 2)) & 1 : luma_bit(mbB, k + 2);
      cbp |= ce.decision(73 + (1 - ba) + 2 * (1 - bb)) << k;
    }
    if (!chroma) return cbp;
    int ca = chroma_of(mbA), cb = chroma_of(mbB);
    if (!ce.decision(77 + (ca > 0) + 2 * (cb > 0))) return cbp;
    return cbp | ((1 + ce.decision(81 + (ca == 2) + 2 * (cb == 2))) << 4);
  }
  __device__ int cabac_dqp() {
    int inc = prev_dqp != 0, n = 0;
    while (ce.decision(60 + inc)) {
      inc = inc < 2 ? 2 : 3;
      if (++n > 102) {
        fail(E_RANGE);
        return 0;
      }
    }
    return (n & 1) ? (n + 1) >> 1 : -((n + 1) >> 1);
  }
  __device__ int cpred_cond(int m) {
    if (m < 0) return 0;
    int t = type(m);
    return (t == T_I4 || t == T_I8 || t == T_I16) && row(m)[F_CPRED] != 0;
  }
  __device__ int cabac_cpred() {
    if (!ce.decision(64 + cpred_cond(mbA) + cpred_cond(mbB))) return 0;
    if (!ce.decision(67)) return 1;
    return ce.decision(67) ? 3 : 2;
  }
  __device__ int cabac_t8() {
    int inc = (mbA >= 0 && row(mbA)[F_T8]) + (mbB >= 0 && row(mbB)[F_T8]);
    return ce.decision(399 + inc);
  }

  // ---- macroblock layer
  __device__ __noinline__ void macroblock() {
    int t = cabac ? cabac_mb_type() : bs.ue();
    int intra = -1;
    if (st == ST_I) {
      intra = t;
    } else if (st == ST_P) {
      if (t > 30) { fail(E_RANGE); return; }
      if (t >= 5) intra = t - 5;
    } else {
      if (t > 48) { fail(E_RANGE); return; }
      if (t >= 23) intra = t - 23;
    }
    if (intra >= 0) {
      if (intra > 25) { fail(E_RANGE); return; }
      intra_mb(intra);
      return;
    }
    if (st == ST_P) {
      if (t >= 3) { inter_8x8(t == 4); return; }
      if (t == 0) inter_mb(0, 1, 0);
      else inter_mb(t == 1 ? 1 : 2, 1, 1);
      return;
    }
    if (t == 0) { b_direct(); return; }
    if (t == 22) { inter_8x8(0); return; }
    if (t <= 3) { inter_mb(0, t, 0); return; }
    const int pairs[9][2] = {{1, 1}, {2, 2}, {1, 2}, {2, 1}, {1, 3}, {2, 3}, {3, 1}, {3, 2}, {3, 3}};
    int k = t - 4;
    inter_mb(k % 2 == 0 ? 1 : 2, pairs[k / 2][0], pairs[k / 2][1]);
  }

  __device__ int chroma_mode() {
    if (!chroma) return 0;
    int m = cabac ? cabac_cpred() : bs.ue();
    if (m > 3) fail(E_RANGE);
    row(mb)[F_CPRED] = m;
    return m;
  }

  __device__ int pred_mode(int blk) {
    int modes[2], k = 0;
    int ms[2], bs2[2];
    left4(blk, ms[0], bs2[0]);
    top4(blk, ms[1], bs2[1]);
    for (int i = 0; i < 2; i++) {
      int m = ms[i];
      if (m < 0 || (cip && !is_intra(m))) return 2;
      int t = type(m);
      modes[k++] = (t == T_I4 || t == T_I8) ? imode_of(m, bs2[i]) : 2;
    }
    return imin(modes[0], modes[1]);
  }

  __device__ __noinline__ void intra_mb(int t) {
    int32_t* rw = row(mb);
    if (t == 25) { pcm(); return; }
    if (t == 0) {
      int t8 = 0;
      if (t8mode) t8 = cabac ? cabac_t8() : bs.u(1);
      rw[F_T8] = t8;
      rw[F_TYPE] = t8 ? T_I8 : T_I4;
      for (int blk = 0; blk < 16; blk += t8 ? 4 : 1) {
        int pred = pred_mode(blk), flag, r = 0;
        if (cabac) {
          flag = ce.decision(68);
          if (!flag) {
            r = ce.decision(69);
            r |= ce.decision(69) << 1;
            r |= ce.decision(69) << 2;
          }
        } else {
          flag = bs.u(1);
          if (!flag) r = bs.u(3);
        }
        int mode = flag ? pred : (r < pred ? r : r + 1);
        for (int b = blk; b < blk + (t8 ? 4 : 1); b++) set_imode(b, mode);
      }
      chroma_mode();
      rw[F_CBP] = coded_block_pattern(1);
    } else {
      int k = t - 1;
      rw[F_TYPE] = T_I16;
      rw[F_CBP] = (k >= 12 ? 15 : 0) | (((k % 12) / 4) << 4);
      rw[F_I16] = k % 4;
      chroma_mode();
    }
    residual_and_qp();
    finish();
  }

  __device__ int coded_block_pattern(int intra) {
    if (cabac) return cabac_cbp();
    int k = bs.ue();
    if (!chroma) {
      if (k > 15) { fail(E_RANGE); return 0; }
      return T[O_CBP400 + (intra ? 16 : 0) + k];
    }
    if (k > 47) { fail(E_RANGE); return 0; }
    return T[(intra ? O_CBP_INTRA : O_CBP_INTER) + k];
  }

  __device__ void pcm() {
    int32_t* rw = row(mb);
    rw[F_TYPE] = T_PCM;
    rw[F_CBP] = 0x2F;
    prev_dqp = 0;
    uint8_t* s = scr(mb);
    for (int i = 0; i < 16; i++) s[SC_COUNT + i] = 16;
    for (int i = 0; i < 8; i++) s[SC_CCOUNT + i] = 16;
    s[SC_DC] = s[SC_DC + 1] = s[SC_DC + 2] = 1;
    int n = 256 + (chroma ? 128 : 0);
    if (cabac) bs.pos = ce.bs->pos;
    while (bs.pos % 8)
      if (bs.u(1)) fail(E_RANGE);
    int16_t* lv = lev + (int64_t)mb * N_LEVELS;
    for (int i = 0; i < n; i++) lv[i] = (int16_t)bs.u(8);
    if (cabac) ce.start();
    finish();
  }

  __device__ int ref_idx(int lx, int blk) {
    int n = nref[lx];
    if (n == 1) return 0;
    int r;
    if (cabac) r = cabac_ref(lx, blk);
    else r = n == 2 ? 1 - bs.bit() : bs.ue();
    if (r >= n) fail(E_RANGE);
    return r;
  }

  __device__ void mvd(int lx, const int* blocks, int nb_) {
    int32_t* rw = row(mb);
    for (int c = 0; c < 2; c++) {
      int d = cabac ? cabac_mvd(lx, blocks[0], c) : bs.se();
      if (d < -8192 || d > 8191) fail(E_RANGE);
      for (int i = 0; i < nb_; i++) rw[F_MVD + (lx * 16 + blocks[i]) * 2 + c] = d;
    }
  }

  __device__ int part_blocks(int part, int j, int* out) {
    int n = 0;
    if (part == 0) {
      for (int b = 0; b < 16; b++) out[n++] = b;
    } else if (part == 1) {
      for (int b = 8 * j; b < 8 * j + 8; b++) out[n++] = b;
    } else {
      for (int k = j; k <= j + 2; k += 2)
        for (int b = 4 * k; b < 4 * k + 4; b++) out[n++] = b;
    }
    return n;
  }

  __device__ int sub_blocks(int k, int shape, int j, int* out) {
    int base = 4 * k;
    if (shape == 0) { out[0] = base; out[1] = base + 1; out[2] = base + 2; out[3] = base + 3; return 4; }
    if (shape == 1) { out[0] = base + 2 * j; out[1] = base + 2 * j + 1; return 2; }
    if (shape == 2) { out[0] = base + j; out[1] = base + j + 2; return 2; }
    out[0] = base + j;
    return 1;
  }

  __device__ __noinline__ void inter_mb(int part, int p0, int p1) {
    int32_t* rw = row(mb);
    rw[F_TYPE] = T_INTER;
    int nparts = part == 0 ? 1 : 2;
    int preds[2] = {p0, p1};
    int blocks[16];
    for (int lx = 0; lx < 2; lx++)
      for (int j = 0; j < nparts; j++)
        if ((preds[j] >> lx) & 1) {
          int n = part_blocks(part, j, blocks);
          int r = ref_idx(lx, blocks[0]);
          for (int i = 0; i < n; i += 4) set_ref(lx, blocks[i] >> 2, r);
        }
    for (int lx = 0; lx < 2; lx++)
      for (int j = 0; j < nparts; j++)
        if ((preds[j] >> lx) & 1) {
          int n = part_blocks(part, j, blocks);
          mvd(lx, blocks, n);
        }
    inter_residual(0);
    rw[F_PART] = part;
    rw[F_PRED] = p0 | (p1 << 2);
    finish();
  }

  __device__ __noinline__ void inter_8x8(int ref0) {
    int32_t* rw = row(mb);
    rw[F_TYPE] = T_INTER;
    int subs[4];
    const int bsubs[13] = {SUB_DIRECT, 4, 8, 12, 1 | 4, 2 | 4, 1 | 8, 2 | 8, 1 | 12, 2 | 12, 3 | 4, 3 | 8, 3 | 12};
    for (int k = 0; k < 4; k++) {
      int s = cabac ? cabac_sub_type() : bs.ue();
      if (s > (st == ST_P ? 3 : 12)) { fail(E_RANGE); s = 0; }
      subs[k] = st == ST_P ? (s | 4) : bsubs[s];
      if (subs[k] == SUB_DIRECT) scr(mb)[SC_DIRECT + k] = 1;
    }
    for (int lx = 0; lx < 2; lx++)
      for (int k = 0; k < 4; k++)
        if (subs[k] != SUB_DIRECT && ((subs[k] >> 2) >> lx) & 1) set_ref(lx, k, ref0 ? 0 : ref_idx(lx, 4 * k));
    int blocks[4];
    for (int lx = 0; lx < 2; lx++)
      for (int k = 0; k < 4; k++) {
        int code = subs[k];
        if (code == SUB_DIRECT || !(((code >> 2) >> lx) & 1)) continue;
        int shape = code & 3, parts = shape == 0 ? 1 : (shape == 3 ? 4 : 2);
        for (int j = 0; j < parts; j++) {
          int n = sub_blocks(k, shape, j, blocks);
          mvd(lx, blocks, n);
        }
      }
    int small = 0;
    for (int k = 0; k < 4; k++) {
      if (subs[k] != SUB_DIRECT && (subs[k] & 3) != 0) small = 1;
      if (!direct8 && subs[k] == SUB_DIRECT) small = 1;
    }
    inter_residual(small);
    rw[F_PART] = 3;
    uint32_t sub = 0;
    for (int k = 0; k < 4; k++) sub |= (uint32_t)subs[k] << (5 * k);
    rw[F_SUB] = (int32_t)sub;
    finish();
  }

  __device__ void b_direct() {
    row(mb)[F_TYPE] = T_BDIRECT;
    for (int k = 0; k < 4; k++) scr(mb)[SC_DIRECT + k] = 1;
    inter_residual(!direct8);
    finish();
  }

  __device__ void inter_residual(int small) {
    int32_t* rw = row(mb);
    int cbp = coded_block_pattern(0);
    rw[F_CBP] = cbp;
    if ((cbp & 15) && t8mode && !small) rw[F_T8] = cabac ? cabac_t8() : bs.u(1);
    residual_and_qp();
  }

  __device__ void residual_and_qp() {
    int32_t* rw = row(mb);
    int cbp = rw[F_CBP], i16 = rw[F_TYPE] == T_I16;
    if (cbp || i16) {
      int d = cabac ? cabac_dqp() : bs.se();
      if (d < -26 || d > 25) fail(E_RANGE);
      qp = (qp + d + 52) % 52;
      prev_dqp = d;
    } else {
      prev_dqp = 0;
    }
    if (cbp || i16) residual(i16);
  }

  // ---- residual: neighbour state
  __device__ int luma_count(int m, int b, int* ok) {
    if (m < 0) { *ok = 0; return 0; }
    *ok = 1;
    if (type(m) == T_PCM) return 16;
    return scr(m)[SC_COUNT + b];
  }
  __device__ int chroma_count(int m, int c, int comp, int* ok) {
    if (m < 0) { *ok = 0; return 0; }
    *ok = 1;
    if (type(m) == T_PCM) return 16;
    return scr(m)[SC_CCOUNT + 4 * comp + c];
  }
  __device__ int cbf_luma(int m, int b) {
    if (m < 0) return is_intra(mb);
    int t = type(m);
    if (t == T_PCM) return 1;
    if (t == T_PSKIP || t == T_BSKIP || !((row(m)[F_CBP] >> (b >> 2)) & 1)) return 0;
    if (row(m)[F_T8]) return 1;
    return scr(m)[SC_COUNT + b] > 0;
  }
  __device__ int cbf_chroma_ac(int m, int c, int comp) {
    if (m < 0) return is_intra(mb);
    int t = type(m);
    if (t == T_PCM) return 1;
    if (t == T_PSKIP || t == T_BSKIP || (row(m)[F_CBP] >> 4) != 2) return 0;
    return scr(m)[SC_CCOUNT + 4 * comp + c] > 0;
  }
  __device__ int cbf_dc(int m, int which) {
    if (m < 0) return is_intra(mb);
    int t = type(m);
    if (t == T_PCM) return 1;
    if (which == 0) return t == T_I16 ? scr(m)[SC_DC] : 0;
    if (t == T_PSKIP || t == T_BSKIP || (row(m)[F_CBP] >> 4) == 0) return 0;
    return scr(m)[SC_DC + which];
  }

  __device__ __noinline__ void residual(int i16) {
    int32_t* rw = row(mb);
    int16_t* lv = lev + (int64_t)mb * N_LEVELS;
    int cbp = rw[F_CBP], t8 = rw[F_T8];
    const int* zz4 = T + O_ZZ4;
    const int* zz8 = T + O_ZZ8;
    int c[64];
    if (i16) {
      block(0, 16, 0, 0, 0, c);
      for (int i = 0; i < 16; i++) lv[L_DC + zz4[i]] = (int16_t)c[i];
    }
    for (int k = 0; k < 4; k++) {
      if (!((cbp >> k) & 1)) continue;
      if (t8 && cabac) {
        block(5, 64, 0, 4 * k, 0, c);
        int cnt = 0;
        for (int i = 0; i < 64; i++) {
          lv[64 * k + zz8[i]] = (int16_t)c[i];
          cnt += c[i] != 0;
        }
        for (int b = 4 * k; b < 4 * k + 4; b++) scr(mb)[SC_COUNT + b] = (uint8_t)cnt;
        continue;
      }
      for (int b = 4 * k; b < 4 * k + 4; b++) {
        if (i16) {
          block(1, 15, 1, b, 0, c);
          for (int i = 0; i < 15; i++) lv[16 * b + zz4[i + 1]] = (int16_t)c[i];
        } else if (t8) {
          block(2, 16, 1, b, 0, c);
          for (int i = 0; i < 16; i++) lv[64 * k + zz8[4 * i + (b - 4 * k)]] = (int16_t)c[i];
        } else {
          block(2, 16, 1, b, 0, c);
          for (int i = 0; i < 16; i++) lv[16 * b + zz4[i]] = (int16_t)c[i];
        }
      }
    }
    if (!chroma || !(cbp >> 4)) return;
    for (int comp = 0; comp < 2; comp++) {
      block(3, 4, 2, comp, comp, c);
      for (int i = 0; i < 4; i++) lv[L_CDC + 4 * comp + i] = (int16_t)c[i];
    }
    if ((cbp >> 4) != 2) return;
    for (int comp = 0; comp < 2; comp++)
      for (int cc = 0; cc < 4; cc++) {
        block(4, 15, 3, cc, comp, c);
        for (int i = 0; i < 15; i++) lv[L_CAC + 64 * comp + 16 * cc + zz4[i + 1]] = (int16_t)c[i];
      }
  }

  // kind: 0 luma DC, 1 luma 4x4 (b = blk), 2 chroma DC (comp), 3 chroma AC (b = chroma block)
  __device__ void block(int cat, int n, int kind, int b, int comp, int* out) {
    for (int i = 0; i < n; i++) out[i] = 0;
    if (cabac) cabac_block(cat, n, kind, b, comp, out);
    else cavlc_block(n, kind, b, comp, out);
    int cnt = 0;
    for (int i = 0; i < n; i++) cnt += out[i] != 0;
    uint8_t* s = scr(mb);
    if (kind == 0) s[SC_DC] = cnt > 0;
    else if (kind == 1 && cat != 5) s[SC_COUNT + b] = (uint8_t)cnt;
    else if (kind == 2) s[SC_DC + 1 + comp] = cnt > 0;
    else if (kind == 3) s[SC_CCOUNT + 4 * comp + b] = (uint8_t)cnt;
  }

  // a prefix code of (len, bits) pairs: the index of the one matching the next bits
  __device__ int vlc(const int* lens, const int* bits, int n) {
    int peek = bs.peek16();
    for (int i = 0; i < n; i++) {
      int l = lens[i];
      if (l && (peek >> (16 - l)) == bits[i]) {
        bs.pos += l;
        return i;
      }
    }
    fail(E_VLC);
    return 0;
  }

  __device__ __noinline__ void cavlc_block(int n, int kind, int b, int comp, int* out) {
    int table;
    if (kind == 2) {
      table = 4;
    } else {
      int na, oka, nbv, okb, ma, ba, mbb, bb;
      if (kind <= 1) {
        int bl = kind == 0 ? 0 : b;
        left4(bl, ma, ba);
        top4(bl, mbb, bb);
        na = luma_count(ma, ba, &oka);
        nbv = luma_count(mbb, bb, &okb);
      } else {
        if (b & 1) { ma = mb; ba = b - 1; } else { ma = mbA; ba = b + 1; }
        if (b & 2) { mbb = mb; bb = b - 2; } else { mbb = mbB; bb = b + 2; }
        na = chroma_count(ma, ba, comp, &oka);
        nbv = chroma_count(mbb, bb, comp, &okb);
      }
      int nc = (oka && okb) ? (na + nbv + 1) >> 1 : (oka ? na : (okb ? nbv : 0));
      table = nc < 2 ? 0 : (nc < 4 ? 1 : (nc < 8 ? 2 : 3));
    }
    int tok = table == 4 ? vlc(T + O_CDC_LEN, T + O_CDC_BITS, 20) : vlc(T + O_CT_LEN + table * 68, T + O_CT_BITS + table * 68, 68);
    int tc = tok >> 2, t1 = tok & 3;
    if (tc > n) { fail(E_RANGE); return; }
    if (!tc) return;
    int levels[16], runs[16];
    int suffix = (tc > 10 && t1 < 3) ? 1 : 0;
    for (int i = 0; i < tc; i++) {
      if (i < t1) {
        levels[i] = bs.bit() ? -1 : 1;
        continue;
      }
      int prefix = 0;
      while (bs.bit() == 0) {
        if (++prefix > 32 || bs.err) { fail(E_RANGE); return; }
      }
      int code = imin(15, prefix) << suffix;
      int size = (prefix == 14 && suffix == 0) ? 4 : (prefix >= 15 ? prefix - 3 : suffix);
      if (size) code += bs.u(size);
      if (prefix >= 15 && suffix == 0) code += 15;
      if (prefix >= 16) code += (1 << (prefix - 3)) - 4096;
      if (i == t1 && t1 < 3) code += 2;
      int level = (code % 2 == 0) ? (code + 2) >> 1 : (-code - 1) >> 1;
      levels[i] = level;
      if (suffix == 0) suffix = 1;
      if (iabs(level) > (3 << (suffix - 1)) && suffix < 6) suffix++;
    }
    int zeros = 0;
    if (tc < n) {
      if (table == 4) zeros = vlc(T + O_CTZ_LEN + (tc - 1) * 4, T + O_CTZ_BITS + (tc - 1) * 4, 4);
      else zeros = vlc(T + O_TZ_LEN + (tc - 1) * 16, T + O_TZ_BITS + (tc - 1) * 16, 16);
    }
    if (zeros + tc > n) { fail(E_RANGE); return; }
    for (int i = 0; i < tc - 1; i++) {
      int r = 0;
      if (zeros > 0) {
        int k = imin(zeros, 7) - 1;
        r = vlc(T + O_RUN_LEN + k * 16, T + O_RUN_BITS + k * 16, 16);
      }
      if (r > zeros) { fail(E_RANGE); return; }
      runs[i] = r;
      zeros -= r;
    }
    runs[tc - 1] = zeros;
    int pos = -1;
    for (int i = tc - 1; i >= 0; i--) {
      pos += runs[i] + 1;
      out[pos] = levels[i];
    }
  }

  __device__ __noinline__ void cabac_block(int cat, int n, int kind, int b, int comp, int* out) {
    if (cat != 5) {
      int inc;
      if (kind == 0) {
        inc = cbf_dc(mbA, 0) + 2 * cbf_dc(mbB, 0);
      } else if (kind == 1) {
        int ma, ba, mbb, bb;
        left4(b, ma, ba);
        top4(b, mbb, bb);
        inc = cbf_luma(ma, ba) + 2 * cbf_luma(mbb, bb);
      } else if (kind == 2) {
        inc = cbf_dc(mbA, 1 + comp) + 2 * cbf_dc(mbB, 1 + comp);
      } else {
        int ma, ca, mbb, cb;
        if (b & 1) { ma = mb; ca = b - 1; } else { ma = mbA; ca = b + 1; }
        if (b & 2) { mbb = mb; cb = b - 2; } else { mbb = mbB; cb = b + 2; }
        inc = cbf_chroma_ac(ma, ca, comp) + 2 * cbf_chroma_ac(mbb, cb, comp);
      }
      if (!ce.decision(85 + 4 * cat + inc)) return;
    }
    int sig_base, last_base, abs_base;
    if (cat == 5) {
      sig_base = 402; last_base = 417; abs_base = 426;
    } else {
      const int off[5] = {0, 15, 29, 44, 47}, aoff[5] = {0, 10, 20, 30, 39};
      sig_base = 105 + off[cat]; last_base = 166 + off[cat]; abs_base = 227 + aoff[cat];
    }
    uint8_t sig[64];
    for (int i = 0; i < n; i++) sig[i] = 0;
    int i = 0;
    for (; i < n - 1; i++) {
      int si, li;
      if (cat == 5) { si = sig_base + T[O_SIG8 + i]; li = last_base + T[O_LAST8 + i]; }
      else if (cat == 3) { si = sig_base + imin(i, 2); li = last_base + imin(i, 2); }
      else { si = sig_base + i; li = last_base + i; }
      if (ce.decision(si)) {
        sig[i] = 1;
        if (ce.decision(li)) break;
      }
    }
    if (i == n - 1) sig[n - 1] = 1;
    int eq1 = 0, gt1 = 0;
    for (int k = n - 1; k >= 0; k--) {
      if (!sig[k]) continue;
      int level;
      int inc = gt1 ? 0 : imin(4, 1 + eq1);
      if (!ce.decision(abs_base + inc)) {
        level = 1;
        eq1++;
      } else {
        int ctx = abs_base + 5 + imin(4 - (cat == 3), gt1);
        int m = 1;
        while (m < 14 && ce.decision(ctx)) m++;
        if (m >= 14) {
          int kk = 0;
          while (ce.bypass()) {
            m += 1 << kk;
            if (++kk > 24) { fail(E_RANGE); return; }
          }
          while (kk--) m += ce.bypass() << kk;
        }
        level = m + 1;
        gt1++;
      }
      out[k] = ce.bypass() ? -level : level;
    }
  }

  // ---- the slice
  __device__ void run() {
    qp = sl[S_QP];
    prev_dqp = 0;
    if (cabac) {
      while (bs.pos % 8)
        if (bs.u(1) != 1) { fail(E_RANGE); return; }
      ce.bs = &bs;
      ce.T = T;
      ce.start();
      const int* table = T + O_CABAC + (st == ST_I ? 3 : sl[S_IDC]) * 2048;
      int q = clip3(0, 51, qp);
      for (int k = 0; k < 1024; k++) {
        int pre = clip3(1, 126, ((table[2 * k] * q) >> 4) + table[2 * k + 1]);
        ce.state[k] = (uint8_t)(pre <= 63 ? (63 - pre) << 1 : ((pre - 64) << 1) | 1);
      }
    }
    int m = first;
    while (!err && !bs.err) {
      if (st != ST_I && !cabac) {
        int run_ = bs.ue();
        for (int k = 0; k < run_ && !err; k++) {
          if (m >= nmb) { fail(E_OVERRUN); return; }
          enter(m);
          skip_mb();
          m++;
        }
        if (run_ > 0 && !bs.more_rbsp_data()) break;
      }
      if (m >= nmb) { fail(E_OVERRUN); return; }
      enter(m);
      if (st != ST_I && cabac && mb_skip_flag()) skip_mb();
      else macroblock();
      m++;
      if (!cabac) {
        if (!bs.more_rbsp_data()) break;
      } else if (ce.terminate()) {
        break;
      }
    }
    if (bs.err && !err) err = bs.err;
    if (!err && !cabac && bs.more_rbsp_data()) err = E_TRAILING;
  }
};

__global__ void h264_parse_kernel(const uint8_t* bits, const int32_t* slices, int nslice, const int32_t* tables,
                                  int32_t* tab, int16_t* lev, uint8_t* scratch, int pic_mbs, int32_t* status) {
  __shared__ uint8_t state[1024];
  const int s = blockIdx.x;
  if (s >= nslice || threadIdx.x != 0) return;
  const int32_t* sl = slices + (int64_t)s * S_FIELDS;
  Parser p;
  p.T = tables;
  p.sl = sl;
  p.bs.data = bits + sl[S_OFFSET];
  p.bs.pos = sl[S_BIT];
  p.bs.end = (int64_t)sl[S_BYTES] * 8;
  p.bs.err = 0;
  p.ce.state = state;
  p.ce.bs = &p.bs;
  p.ce.T = tables;
  int pic = sl[S_PIC];
  p.tab = tab + (int64_t)pic * pic_mbs * N_FIELDS;
  p.lev = lev + (int64_t)pic * pic_mbs * N_LEVELS;
  p.sc = scratch + (int64_t)pic * pic_mbs * N_SCRATCH;
  p.slice_index = sl[S_INDEX];
  p.first = sl[S_FIRST];
  p.st = sl[S_TYPE];
  p.cabac = sl[S_CABAC];
  p.cip = sl[S_CIP];
  p.t8mode = sl[S_T8MODE];
  p.direct8 = sl[S_DIRECT8];
  p.chroma = sl[S_CHROMA];
  p.mbw = sl[S_MBW];
  p.mbh = sl[S_MBH];
  p.nmb = p.mbw * p.mbh;
  p.nref[0] = sl[S_NREF0];
  p.nref[1] = sl[S_NREF1];
  p.err = 0;
  p.mb = p.first;
  p.run();
  status[2 * s] = p.err;
  status[2 * s + 1] = (int32_t)p.bs.pos;
}

}  // namespace

extern "C" {

const char* dspnet_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int dspnet_h264_parse(const void* bits, const void* slices, int nslice, const void* tables, void* tab, void* lev,
                      void* scratch, int pic_mbs, void* status, void* stream) {
  H264_LAUNCH(h264_parse_kernel, nslice, 1, (cudaStream_t)stream)(
      (const uint8_t*)bits, (const int32_t*)slices, nslice, (const int32_t*)tables, (int32_t*)tab, (int16_t*)lev,
      (uint8_t*)scratch, pic_mbs, (int32_t*)status);
  return (int)cudaGetLastError();
}

}  // extern "C"
