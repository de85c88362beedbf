// The H.264 reconstruction and deblocking kernels as they stood before their
// redesign for Hopper, kept on no path as a yardstick: chip_smoke.py builds
// this file beside dspnet_torch/csrc/h264.cu and times both on the same
// inputs (phase 23). Same entry points, tables and layouts as the current
// wrapper (dspnet_torch/data/h264_cuda.py) passes; the slice-data parse is
// left out (it did not change).
//
// h264_recon_kernel: one launch per picture, one thread block; macroblock
// (x, y) runs in wave x + 2y (its left, top, top-right and top-left
// neighbours, which intra prediction and motion vector prediction read, are
// in earlier waves), a thread per macroblock of the wave, __syncthreads
// between waves. Each thread derives the motion vectors, predicts each 4x4
// block (6-tap luma, bilinear chroma, weighted prediction), dequantises and
// inverse transforms the residual into per-thread arrays and adds it, or
// predicts intra blocks in order.
//
// h264_deblock_kernel: one launch per picture, one thread block, the same
// waves, a thread per macroblock filtering its vertical and then horizontal
// edges in place, one line after another.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef H264_LAUNCH
#define H264_LAUNCH(kernel, grid, block, stream) kernel<<<(grid), (block), 0, (stream)>>>
#endif
// the largest block of the wave kernels (they stride rows by blockDim; a
// host emulation builds with a small one)
#ifndef H264_MAX_THREADS
#define H264_MAX_THREADS 1024
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

// ================================================================== reconstruction

// per-slice records (h264_cuda.RECORD words; the POCs at 80-143 are the host's)
enum { R_TYPE, R_SPATIAL, R_WEIGHTED, R_LDENOM, R_CDENOM, R_CIP, R_DIRECT8, R_CBOFF, R_CROFF, R_DBIDC, R_DBA, R_DBB,
       R_NREF0, R_NREF1 };
constexpr int R_SLOT = 16, R_LONG = 144, R_PID = 208, R_WEIGHTS = 272, R_IMPLICIT = 656, R_DSF = 1680,
              R_LS4 = 1712, R_LS8 = 2288, R_SIZE = 3056;
constexpr int NO_DSF = 1 << 20;

struct Pic {
  const int32_t* tab;
  const int16_t* lev;
  const int32_t* rec;  // slice records
  const int64_t* refs; // per slot: Y, U, V device pointers
  const int32_t* T;
  int mbw, mbh, chroma, poc, ys, cs;  // strides of Y and chroma planes
  uint8_t *Y, *U, *V;
  int32_t *mv, *ref, *rid;              // the picture's motion field
  const int32_t *cmv, *cref, *crid;     // the co-located picture's (or null)
  int w4, h4;
};

struct Nb {
  int ok, ref, mx, my;
};

__device__ int read_ref(const int32_t* row, int lx, int k) {
  int r = (row[F_REF0 + lx] >> (8 * k)) & 0xFF;
  return r == 0xFF ? -1 : r;
}

__device__ int imedian(int a, int b, int c) { return imax(imin(a, b), imin(imax(a, b), c)); }

struct Mv {
  const Pic* P;
  int mb, slice, mbx4, mby4;
  uint16_t done;  // the current macroblock's 4x4 blocks done
  __device__ int64_t at(int lx, int y4, int x4) const { return ((int64_t)lx * P->h4 + y4) * P->w4 + x4; }
  __device__ Nb nb(int x4, int y4, int lx) const {
    Nb n = {0, -1, 0, 0};
    if (x4 < 0 || y4 < 0 || x4 >= P->w4 || y4 >= P->h4) return n;
    int m = (y4 >> 2) * P->mbw + (x4 >> 2);
    if (P->tab[(int64_t)m * N_FIELDS + F_SLICE] != slice) return n;
    if (m > mb) return n;
    if (m == mb && !((done >> blk_at(y4 & 3, x4 & 3)) & 1)) return n;
    n.ok = 1;
    int64_t i = at(lx, y4, x4);
    int r = P->ref[i];
    if (r < 0) return n;
    n.ref = r;
    n.mx = P->mv[2 * i];
    n.my = P->mv[2 * i + 1];
    return n;
  }
  __device__ void neighbours(int x4, int y4, int w4, int lx, Nb& a, Nb& b, Nb& c) const {
    a = nb(x4 - 1, y4, lx);
    b = nb(x4, y4 - 1, lx);
    c = nb(x4 + w4, y4 - 1, lx);
    if (!c.ok) c = nb(x4 - 1, y4 - 1, lx);
  }
  // shape 0 median only, 1 16x8, 2 8x16
  __device__ void mvp(int x4, int y4, int w4, int lx, int ref, int shape, int part, int& px, int& py) const {
    Nb a, b, c;
    neighbours(x4, y4, w4, lx, a, b, c);
    if (shape == 1) {
      if (part == 0 && b.ref == ref) { px = b.mx; py = b.my; return; }
      if (part == 1 && a.ref == ref) { px = a.mx; py = a.my; return; }
    } else if (shape == 2) {
      if (part == 0 && a.ref == ref) { px = a.mx; py = a.my; return; }
      if (part == 1 && c.ref == ref) { px = c.mx; py = c.my; return; }
    }
    if (!b.ok && !c.ok && a.ok) { b = a; c = a; }
    int match = (a.ref == ref) + (b.ref == ref) + (c.ref == ref);
    if (match == 1) {
      const Nb& n = a.ref == ref ? a : (b.ref == ref ? b : c);
      px = n.mx;
      py = n.my;
      return;
    }
    px = imedian(a.mx, b.mx, c.mx);
    py = imedian(a.my, b.my, c.my);
  }
  __device__ void store(int blk, int lx, int ref, int mx, int my, int pid) const {
    int64_t i = at(lx, mby4 + blk_y(blk), mbx4 + blk_x(blk));
    P->ref[i] = ref;
    P->mv[2 * i] = mx;
    P->mv[2 * i + 1] = my;
    P->rid[i] = pid;
  }
  __device__ void colocated(int x4, int y4, int& mx, int& my, int& refc, int& ridc) const {
    int64_t i0 = ((int64_t)0 * P->h4 + y4) * P->w4 + x4, i1 = ((int64_t)1 * P->h4 + y4) * P->w4 + x4;
    int64_t i;
    if (P->cref[i0] >= 0) i = i0;
    else if (P->cref[i1] >= 0) i = i1;
    else { mx = my = 0; refc = -1; ridc = -1; return; }
    mx = P->cmv[2 * i];
    my = P->cmv[2 * i + 1];
    refc = P->cref[i];
    ridc = P->crid[i];
  }
};

__device__ __noinline__ void derive_mb(const Pic& P, int mb, const int32_t* row, const int32_t* rec, Mv& M) {
  int t = row[F_TYPE];
  if (t <= T_PCM) {
    M.done = 0xFFFF;
    return;
  }
  const int* slot_pid0 = rec + R_PID;
  const int* slot_pid1 = rec + R_PID + 32;
  int refs[2][4];
  for (int lx = 0; lx < 2; lx++)
    for (int k = 0; k < 4; k++) refs[lx][k] = read_ref(row, lx, k);
  if (t == T_PSKIP) {
    Nb a, b, c;
    M.neighbours(M.mbx4, M.mby4, 4, 0, a, b, c);
    int mx = 0, my = 0;
    if (!(!a.ok || !b.ok || (a.ref == 0 && a.mx == 0 && a.my == 0) || (b.ref == 0 && b.mx == 0 && b.my == 0)))
      M.mvp(M.mbx4, M.mby4, 4, 0, 0, 0, 0, mx, my);
    for (int b2 = 0; b2 < 16; b2++) M.store(b2, 0, 0, mx, my, slot_pid0[0]);
    M.done = 0xFFFF;
    return;
  }
  // direct prediction of 8x8 block k (B_Skip, B_Direct_16x16, direct sub-blocks)
  int sp_ref[2] = {-1, -1}, sp_mv[2][2] = {{0, 0}, {0, 0}}, sp_done = 0;
  int sub = row[F_SUB];
  for (int k = 0; k < 4; k++) {
    int is_direct = t == T_BSKIP || t == T_BDIRECT || (row[F_PART] == 3 && ((sub >> (5 * k)) & 31) == SUB_DIRECT);
    if (is_direct) {
      if (rec[R_SPATIAL]) {
        if (!sp_done) {
          sp_done = 1;
          for (int lx = 0; lx < 2; lx++) {
            Nb a, b, c;
            M.neighbours(M.mbx4, M.mby4, 4, lx, a, b, c);
            int r = -1;
            const int rr[3] = {a.ref, b.ref, c.ref};
            for (int q = 0; q < 3; q++)
              if (rr[q] >= 0 && (r < 0 || rr[q] < r)) r = rr[q];
            sp_ref[lx] = r;
          }
          for (int lx = 0; lx < 2; lx++)
            if (sp_ref[lx] >= 0) M.mvp(M.mbx4, M.mby4, 4, lx, sp_ref[lx], 0, 0, sp_mv[lx][0], sp_mv[lx][1]);
        }
        int col_long = rec[R_LONG + 32];
        for (int blk = 4 * k; blk < 4 * k + 4; blk++) {
          int bx = blk_x(blk), by = blk_y(blk), cx = bx, cy = by;
          if (rec[R_DIRECT8]) { cx = bx >= 2 ? 3 : 0; cy = by >= 2 ? 3 : 0; }
          int mxc, myc, refc, ridc;
          M.colocated(M.mbx4 + cx, M.mby4 + cy, mxc, myc, refc, ridc);
          int zero = !col_long && refc == 0 && mxc >= -1 && mxc <= 1 && myc >= -1 && myc <= 1;
          if (sp_ref[0] < 0 && sp_ref[1] < 0) {
            M.store(blk, 0, 0, 0, 0, slot_pid0[0]);
            M.store(blk, 1, 0, 0, 0, slot_pid1[0]);
            continue;
          }
          for (int lx = 0; lx < 2; lx++) {
            int r = sp_ref[lx];
            if (r < 0) continue;
            int mx = sp_mv[lx][0], my = sp_mv[lx][1];
            if (r == 0 && zero) mx = my = 0;
            M.store(blk, lx, r, mx, my, rec[R_PID + 32 * lx + r]);
          }
        }
      } else {
        for (int blk = 4 * k; blk < 4 * k + 4; blk++) {
          int bx = blk_x(blk), by = blk_y(blk), cx = bx, cy = by;
          if (rec[R_DIRECT8]) { cx = bx >= 2 ? 3 : 0; cy = by >= 2 ? 3 : 0; }
          int mxc, myc, refc, ridc;
          M.colocated(M.mbx4 + cx, M.mby4 + cy, mxc, myc, refc, ridc);
          int r0 = 0;
          if (refc >= 0) {
            r0 = -1;
            for (int q = 0; q < rec[R_NREF0]; q++)
              if (slot_pid0[q] == ridc) { r0 = q; break; }
            if (r0 < 0) r0 = 0;
          }
          int dsf = rec[R_DSF + r0];
          int m0x, m0y, m1x, m1y;
          if (dsf == NO_DSF) {
            m0x = mxc; m0y = myc; m1x = 0; m1y = 0;
          } else {
            m0x = (dsf * mxc + 128) >> 8;
            m0y = (dsf * myc + 128) >> 8;
            m1x = m0x - mxc;
            m1y = m0y - myc;
          }
          M.store(blk, 0, r0, m0x, m0y, slot_pid0[r0]);
          M.store(blk, 1, 0, m1x, m1y, slot_pid1[0]);
        }
      }
      M.done |= 0xF << (4 * k);
      continue;
    }
    if (row[F_PART] == 3) {
      int code = (sub >> (5 * k)) & 31, shape = code & 3, parts = shape == 0 ? 1 : (shape == 3 ? 4 : 2);
      for (int j = 0; j < parts; j++) {
        int blocks[4], n;
        int base = 4 * k;
        if (shape == 0) { blocks[0] = base; blocks[1] = base + 1; blocks[2] = base + 2; blocks[3] = base + 3; n = 4; }
        else if (shape == 1) { blocks[0] = base + 2 * j; blocks[1] = base + 2 * j + 1; n = 2; }
        else if (shape == 2) { blocks[0] = base + j; blocks[1] = base + j + 2; n = 2; }
        else { blocks[0] = base + j; n = 1; }
        int x4 = M.mbx4 + blk_x(blocks[0]), y4 = M.mby4 + blk_y(blocks[0]);
        int w4 = (shape == 0 || shape == 1) ? 2 : 1;
        for (int lx = 0; lx < 2; lx++)
          if (((code >> 2) >> lx) & 1) {
            int r = refs[lx][k], px, py;
            M.mvp(x4, y4, w4, lx, r, 0, 0, px, py);
            int mx = px + row[F_MVD + (lx * 16 + blocks[0]) * 2], my = py + row[F_MVD + (lx * 16 + blocks[0]) * 2 + 1];
            for (int i = 0; i < n; i++) M.store(blocks[i], lx, r, mx, my, rec[R_PID + 32 * lx + r]);
          }
        for (int i = 0; i < n; i++) M.done |= 1 << blocks[i];
      }
    }
  }
  if (row[F_PART] == 3 || t == T_BSKIP || t == T_BDIRECT) return;
  int part = row[F_PART], pred = row[F_PRED];
  int nparts = part == 0 ? 1 : 2;
  for (int j = 0; j < nparts; j++) {
    int flags = (pred >> (2 * j)) & 3;
    int first = part == 0 ? 0 : (part == 1 ? 8 * j : 4 * j);
    int x4 = M.mbx4 + blk_x(first), y4 = M.mby4 + blk_y(first);
    int w4 = part == 2 ? 2 : 4;
    uint16_t mask = part == 0 ? 0xFFFF : (part == 1 ? (j ? 0xFF00 : 0x00FF) : (j ? 0xF0F0 : 0x0F0F));
    for (int lx = 0; lx < 2; lx++)
      if ((flags >> lx) & 1) {
        int r = refs[lx][first >> 2], px, py;
        M.mvp(x4, y4, w4, lx, r, part, j, px, py);
        int mx = px + row[F_MVD + (lx * 16 + first) * 2], my = py + row[F_MVD + (lx * 16 + first) * 2 + 1];
        for (int b = 0; b < 16; b++)
          if ((mask >> b) & 1) M.store(b, lx, r, mx, my, rec[R_PID + 32 * lx + r]);
      }
    M.done |= mask;
  }
}

// ---- inter prediction of one 4x4 luma block and its two 2x2 chroma blocks
__device__ int luma_sample(const uint8_t* p, int stride, int w, int h, int x, int y) {
  return p[clip3(0, h - 1, y) * stride + clip3(0, w - 1, x)];
}

__device__ __noinline__ void luma_pred4(const uint8_t* p, int stride, int w, int h, int x, int y, int mvx, int mvy, int out[16]) {
  int xi = x + (mvx >> 2) - 2, yi = y + (mvy >> 2) - 2;
  int win[9][9];
  for (int r = 0; r < 9; r++)
    for (int c = 0; c < 9; c++) win[r][c] = luma_sample(p, stride, w, h, xi + c, yi + r);
  int fx = mvx & 3, fy = mvy & 3;
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 4; j++) {
#define TAP(a, b, c, d, e, f) ((a) - 5 * (b) + 20 * (c) + 20 * (d) - 5 * (e) + (f))
      int G = win[i + 2][j + 2];
      int b1r[2], h1c[2];
      for (int k = 0; k < 2; k++) {
        int rr = i + 2 + k;
        b1r[k] = TAP(win[rr][j], win[rr][j + 1], win[rr][j + 2], win[rr][j + 3], win[rr][j + 4], win[rr][j + 5]);
        int cc = j + 2 + k;
        h1c[k] = TAP(win[i][cc], win[i + 1][cc], win[i + 2][cc], win[i + 3][cc], win[i + 4][cc], win[i + 5][cc]);
      }
      int b = clip1((b1r[0] + 16) >> 5), s = clip1((b1r[1] + 16) >> 5);
      int hh = clip1((h1c[0] + 16) >> 5), m = clip1((h1c[1] + 16) >> 5);
      int jj = 0;
      if (fx == 2 || fy == 2) {
        int bcol[6];
        for (int r = 0; r < 6; r++) {
          int rr = i + r;
          bcol[r] = TAP(win[rr][j], win[rr][j + 1], win[rr][j + 2], win[rr][j + 3], win[rr][j + 4], win[rr][j + 5]);
        }
        jj = clip1((TAP(bcol[0], bcol[1], bcol[2], bcol[3], bcol[4], bcol[5]) + 512) >> 10);
      }
#undef TAP
      int Hn = win[i + 2][j + 3], Mn = win[i + 3][j + 2], v;
      switch (fy * 4 + fx) {
        case 0: v = G; break;
        case 4: v = (G + hh + 1) >> 1; break;
        case 8: v = hh; break;
        case 12: v = (Mn + hh + 1) >> 1; break;
        case 1: v = (G + b + 1) >> 1; break;
        case 5: v = (b + hh + 1) >> 1; break;
        case 9: v = (hh + jj + 1) >> 1; break;
        case 13: v = (hh + s + 1) >> 1; break;
        case 2: v = b; break;
        case 6: v = (b + jj + 1) >> 1; break;
        case 10: v = jj; break;
        case 14: v = (jj + s + 1) >> 1; break;
        case 3: v = (Hn + b + 1) >> 1; break;
        case 7: v = (b + m + 1) >> 1; break;
        case 11: v = (jj + m + 1) >> 1; break;
        default: v = (m + s + 1) >> 1; break;
      }
      out[i * 4 + j] = v;
    }
}

__device__ void chroma_pred2(const uint8_t* p, int stride, int w, int h, int x, int y, int mvx, int mvy, int out[4]) {
  int xi = x + (mvx >> 3), yi = y + (mvy >> 3), fx = mvx & 7, fy = mvy & 7;
  for (int i = 0; i < 2; i++)
    for (int j = 0; j < 2; j++) {
      int A = luma_sample(p, stride, w, h, xi + j, yi + i), B = luma_sample(p, stride, w, h, xi + j + 1, yi + i);
      int C = luma_sample(p, stride, w, h, xi + j, yi + i + 1), D = luma_sample(p, stride, w, h, xi + j + 1, yi + i + 1);
      out[i * 2 + j] = ((8 - fx) * (8 - fy) * A + fx * (8 - fy) * B + (8 - fx) * fy * C + fx * fy * D + 32) >> 6;
    }
}

__device__ int weigh(int p0, int p1, int use0, int use1, int w0, int o0, int w1, int o1, int denom, int mode) {
  int both = use0 && use1;
  int use = mode == 1 || (mode == 2 && both);
  if (!use) return clip1(both ? (p0 + p1 + 1) >> 1 : (use0 ? p0 : p1));
  if (both) return clip1(((p0 * w0 + p1 * w1 + (1 << denom)) >> (denom + 1)) + ((o0 + o1 + 1) >> 1));
  int p = use0 ? p0 : p1, w = use0 ? w0 : w1, o = use0 ? o0 : o1;
  if (denom >= 1) return clip1(((p * w + (1 << (denom - 1))) >> denom) + o);
  return clip1(p * w + o);
}

// ---- the residual of one macroblock: luma res[256] (raster 16x16), chroma resc[2][64]
__device__ void idct4(int* d) {  // (4x4 raster in place): rows, columns, (x + 32) >> 6
  for (int r = 0; r < 4; r++) {
    int* a = d + 4 * r;
    int e = a[0] + a[2], f = a[0] - a[2], g = (a[1] >> 1) - a[3], h = a[1] + (a[3] >> 1);
    a[0] = e + h; a[1] = f + g; a[2] = f - g; a[3] = e - h;
  }
  for (int c = 0; c < 4; c++) {
    int a0 = d[c], a1 = d[4 + c], a2 = d[8 + c], a3 = d[12 + c];
    int e = a0 + a2, f = a0 - a2, g = (a1 >> 1) - a3, h = a1 + (a3 >> 1);
    d[c] = (e + h + 32) >> 6; d[4 + c] = (f + g + 32) >> 6; d[8 + c] = (f - g + 32) >> 6; d[12 + c] = (e - h + 32) >> 6;
  }
}

__device__ void idct8_1d(int* v, int step) {
  int x[8];
  for (int k = 0; k < 8; k++) x[k] = v[k * step];
  int a0 = x[0] + x[4], a4 = x[0] - x[4], a2 = (x[2] >> 1) - x[6], a6 = x[2] + (x[6] >> 1);
  int b0 = a0 + a6, b2 = a4 + a2, b4 = a4 - a2, b6 = a0 - a6;
  int a1 = -x[3] + x[5] - x[7] - (x[7] >> 1);
  int a3 = x[1] + x[7] - x[3] - (x[3] >> 1);
  int a5 = -x[1] + x[7] + x[5] + (x[5] >> 1);
  int a7 = x[3] + x[5] + x[1] + (x[1] >> 1);
  int b1 = a1 + (a7 >> 2), b7 = a7 - (a1 >> 2), b3 = a3 + (a5 >> 2), b5 = (a3 >> 2) - a5;
  int o[8] = {b0 + b7, b2 + b5, b4 + b3, b6 + b1, b6 - b1, b4 - b3, b2 - b5, b0 - b7};
  for (int k = 0; k < 8; k++) v[k * step] = o[k];
}

__device__ int deq4(int c, int ls, int qp) {
  int q6 = qp / 6;
  return qp >= 24 ? (c * ls) << (q6 - 4) : (c * ls + (1 << (3 - q6))) >> (4 - q6);
}

__device__ __noinline__ void residual_mb(const Pic& P, const int32_t* row, const int16_t* lv, const int32_t* rec, int* res,
                            int* resc) {
  int t = row[F_TYPE], qp = row[F_QP], intra = t <= T_PCM;
  for (int i = 0; i < 256; i++) res[i] = 0;
  for (int i = 0; i < 128; i++) resc[i] = 0;
  if (t == T_PCM) return;
  const int* ls4 = rec + R_LS4;  // [6 lists][6][16]
  const int* ls8 = rec + R_LS8;  // [2][6][64]
  int d[64];
  if (row[F_T8]) {
    const int* ls = ls8 + ((intra ? 0 : 1) * 6 + qp % 6) * 64;
    int q6 = qp / 6;
    for (int k = 0; k < 4; k++) {
      for (int i = 0; i < 64; i++) {
        int c = lv[64 * k + i];
        d[i] = qp >= 36 ? (c * ls[i]) << (q6 - 6) : (c * ls[i] + (1 << (5 - q6))) >> (6 - q6);
      }
      for (int r = 0; r < 8; r++) idct8_1d(d + 8 * r, 1);
      for (int c = 0; c < 8; c++) idct8_1d(d + c, 8);
      for (int y = 0; y < 8; y++)
        for (int x = 0; x < 8; x++) res[(8 * (k >> 1) + y) * 16 + 8 * (k & 1) + x] = (d[y * 8 + x] + 32) >> 6;
    }
  } else {
    const int* ls = ls4 + ((intra ? 0 : 3) * 6 + qp % 6) * 16;
    int dc[16];
    if (t == T_I16) {
      int c[16], f[16];
      for (int i = 0; i < 16; i++) c[i] = lv[L_DC + i];
      const int H[4][4] = {{1, 1, 1, 1}, {1, 1, -1, -1}, {1, -1, -1, 1}, {1, -1, 1, -1}};
      int tmp[16];
      for (int i = 0; i < 4; i++)
        for (int j = 0; j < 4; j++) {
          int s = 0;
          for (int k = 0; k < 4; k++) s += H[i][k] * c[k * 4 + j];
          tmp[i * 4 + j] = s;
        }
      for (int i = 0; i < 4; i++)
        for (int j = 0; j < 4; j++) {
          int s = 0;
          for (int k = 0; k < 4; k++) s += tmp[i * 4 + k] * H[k][j];
          f[i * 4 + j] = s;
        }
      int q6 = qp / 6;
      for (int i = 0; i < 16; i++)
        dc[i] = qp >= 36 ? (f[i] * ls[0]) << (q6 - 6) : (f[i] * ls[0] + (1 << (5 - q6))) >> (6 - q6);
    }
    for (int b = 0; b < 16; b++) {
      for (int i = 0; i < 16; i++) d[i] = deq4(lv[16 * b + i], ls[i], qp);
      if (t == T_I16) d[0] = dc[blk_y(b) * 4 + blk_x(b)];
      idct4(d);
      int x0 = 4 * blk_x(b), y0 = 4 * blk_y(b);
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) res[(y0 + y) * 16 + x0 + x] = d[y * 4 + x];
    }
  }
  if (!P.chroma) return;
  for (int comp = 0; comp < 2; comp++) {
    int qpc = P.T[O_CQP + clip3(0, 51, qp + rec[R_CBOFF + comp])];
    const int* ls = ls4 + (((intra ? 1 : 4) + comp) * 6 + qpc % 6) * 16;
    const int16_t* c = lv + L_CDC + 4 * comp;
    int f[4] = {c[0] + c[1] + c[2] + c[3], c[0] - c[1] + c[2] - c[3], c[0] + c[1] - c[2] - c[3],
                c[0] - c[1] - c[2] + c[3]};
    for (int k = 0; k < 4; k++) {
      for (int i = 0; i < 16; i++) d[i] = deq4(lv[L_CAC + 64 * comp + 16 * k + i], ls[i], qpc);
      d[0] = ((f[k] * ls[0]) << (qpc / 6)) >> 5;
      idct4(d);
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) resc[comp * 64 + (4 * (k >> 1) + y) * 8 + 4 * (k & 1) + x] = d[y * 4 + x];
    }
  }
}

// ---- intra prediction
__device__ int mb_ok_intra(const Pic& P, int mb, int nb) {
  if (nb < 0) return 0;
  const int32_t* r = P.tab + (int64_t)mb * N_FIELDS;
  const int32_t* n = P.tab + (int64_t)nb * N_FIELDS;
  if (n[F_SLICE] != r[F_SLICE] || nb > mb) return 0;
  if (P.rec[(int64_t)r[F_SLICE] * R_SIZE + R_CIP] && n[F_TYPE] > T_PCM) return 0;
  return 1;
}

__device__ __noinline__ void intra4(int mode, const int* top, const int* left, int tl, int has_top, int has_left, int* P) {
  // top[0..7], left[0..3]; tl is p[-1,-1]
#define T_(i) ((i) < 0 ? tl : top[i])
#define L_(i) ((i) < 0 ? tl : left[i])
  for (int y = 0; y < 4; y++)
    for (int x = 0; x < 4; x++) {
      int v = 0;
      switch (mode) {
        case 0: v = top[x]; break;
        case 1: v = left[y]; break;
        case 2:
          if (has_top && has_left) v = (top[0] + top[1] + top[2] + top[3] + left[0] + left[1] + left[2] + left[3] + 4) >> 3;
          else if (has_left) v = (left[0] + left[1] + left[2] + left[3] + 2) >> 2;
          else if (has_top) v = (top[0] + top[1] + top[2] + top[3] + 2) >> 2;
          else v = 128;
          break;
        case 3:
          v = (x == 3 && y == 3) ? (top[6] + 3 * top[7] + 2) >> 2 : (top[x + y] + 2 * top[x + y + 1] + top[x + y + 2] + 2) >> 2;
          break;
        case 4:
          if (x > y) v = (T_(x - y - 2) + 2 * T_(x - y - 1) + T_(x - y) + 2) >> 2;
          else if (x < y) v = (L_(y - x - 2) + 2 * L_(y - x - 1) + L_(y - x) + 2) >> 2;
          else v = (T_(0) + 2 * tl + L_(0) + 2) >> 2;
          break;
        case 5: {
          int z = 2 * x - y;
          if (z >= 0 && !(z & 1)) v = (T_(x - (y >> 1) - 1) + T_(x - (y >> 1)) + 1) >> 1;
          else if (z >= 0) v = (T_(x - (y >> 1) - 2) + 2 * T_(x - (y >> 1) - 1) + T_(x - (y >> 1)) + 2) >> 2;
          else if (z == -1) v = (L_(0) + 2 * tl + T_(0) + 2) >> 2;
          else v = (L_(y - 1) + 2 * L_(y - 2) + L_(y - 3) + 2) >> 2;
          break;
        }
        case 6: {
          int z = 2 * y - x;
          if (z >= 0 && !(z & 1)) v = (L_(y - (x >> 1) - 1) + L_(y - (x >> 1)) + 1) >> 1;
          else if (z >= 0) v = (L_(y - (x >> 1) - 2) + 2 * L_(y - (x >> 1) - 1) + L_(y - (x >> 1)) + 2) >> 2;
          else if (z == -1) v = (L_(0) + 2 * tl + T_(0) + 2) >> 2;
          else v = (T_(x - 1) + 2 * T_(x - 2) + T_(x - 3) + 2) >> 2;
          break;
        }
        case 7:
          if (!(y & 1)) v = (T_(x + (y >> 1)) + T_(x + (y >> 1) + 1) + 1) >> 1;
          else v = (T_(x + (y >> 1)) + 2 * T_(x + (y >> 1) + 1) + T_(x + (y >> 1) + 2) + 2) >> 2;
          break;
        default: {
          int z = x + 2 * y;
          if (z < 5 && !(z & 1)) v = (L_(y + (x >> 1)) + L_(y + (x >> 1) + 1) + 1) >> 1;
          else if (z < 5) v = (L_(y + (x >> 1)) + 2 * L_(y + (x >> 1) + 1) + L_(y + (x >> 1) + 2) + 2) >> 2;
          else if (z == 5) v = (L_(2) + 3 * L_(3) + 2) >> 2;
          else v = L_(3);
        }
      }
      P[y * 4 + x] = v;
    }
#undef T_
#undef L_
}

__device__ __noinline__ void intra8(int mode, const int* top0, const int* left0, int tl0, int has_top, int has_left, int has_tl,
                       int* P) {
  int ft[16], fl[8], ftl = 0;
  if (has_top) {
    ft[0] = has_tl ? (tl0 + 2 * top0[0] + top0[1] + 2) >> 2 : (3 * top0[0] + top0[1] + 2) >> 2;
    for (int x = 1; x < 15; x++) ft[x] = (top0[x - 1] + 2 * top0[x] + top0[x + 1] + 2) >> 2;
    ft[15] = (top0[14] + 3 * top0[15] + 2) >> 2;
  }
  if (has_tl) {
    if (has_top && has_left) ftl = (top0[0] + 2 * tl0 + left0[0] + 2) >> 2;
    else if (has_top) ftl = (3 * tl0 + top0[0] + 2) >> 2;
    else if (has_left) ftl = (3 * tl0 + left0[0] + 2) >> 2;
    else ftl = tl0;
  }
  if (has_left) {
    fl[0] = has_tl ? (tl0 + 2 * left0[0] + left0[1] + 2) >> 2 : (3 * left0[0] + left0[1] + 2) >> 2;
    for (int y = 1; y < 7; y++) fl[y] = (left0[y - 1] + 2 * left0[y] + left0[y + 1] + 2) >> 2;
    fl[7] = (left0[6] + 3 * left0[7] + 2) >> 2;
  }
#define T_(i) ((i) < 0 ? ftl : ft[i])
#define L_(i) ((i) < 0 ? ftl : fl[i])
  int dc = 128;
  if (mode == 2) {
    int st = 0, sl = 0;
    for (int k = 0; k < 8; k++) {
      if (has_top) st += ft[k];
      if (has_left) sl += fl[k];
    }
    if (has_top && has_left) dc = (st + sl + 8) >> 4;
    else if (has_left) dc = (sl + 4) >> 3;
    else if (has_top) dc = (st + 4) >> 3;
  }
  for (int y = 0; y < 8; y++)
    for (int x = 0; x < 8; x++) {
      int v = 0;
      switch (mode) {
        case 0: v = ft[x]; break;
        case 1: v = fl[y]; break;
        case 2: v = dc; break;
        case 3:
          v = (x == 7 && y == 7) ? (ft[14] + 3 * ft[15] + 2) >> 2 : (ft[x + y] + 2 * ft[x + y + 1] + ft[x + y + 2] + 2) >> 2;
          break;
        case 4:
          if (x > y) v = (T_(x - y - 2) + 2 * T_(x - y - 1) + T_(x - y) + 2) >> 2;
          else if (x < y) v = (L_(y - x - 2) + 2 * L_(y - x - 1) + L_(y - x) + 2) >> 2;
          else v = (T_(0) + 2 * ftl + L_(0) + 2) >> 2;
          break;
        case 5: {
          int z = 2 * x - y;
          if (z >= 0 && !(z & 1)) v = (T_(x - (y >> 1) - 1) + T_(x - (y >> 1)) + 1) >> 1;
          else if (z >= 0) v = (T_(x - (y >> 1) - 2) + 2 * T_(x - (y >> 1) - 1) + T_(x - (y >> 1)) + 2) >> 2;
          else if (z == -1) v = (L_(0) + 2 * ftl + T_(0) + 2) >> 2;
          else v = (L_(y - 2 * x - 1) + 2 * L_(y - 2 * x - 2) + L_(y - 2 * x - 3) + 2) >> 2;
          break;
        }
        case 6: {
          int z = 2 * y - x;
          if (z >= 0 && !(z & 1)) v = (L_(y - (x >> 1) - 1) + L_(y - (x >> 1)) + 1) >> 1;
          else if (z >= 0) v = (L_(y - (x >> 1) - 2) + 2 * L_(y - (x >> 1) - 1) + L_(y - (x >> 1)) + 2) >> 2;
          else if (z == -1) v = (L_(0) + 2 * ftl + T_(0) + 2) >> 2;
          else v = (T_(x - 2 * y - 1) + 2 * T_(x - 2 * y - 2) + T_(x - 2 * y - 3) + 2) >> 2;
          break;
        }
        case 7:
          if (!(y & 1)) v = (T_(x + (y >> 1)) + T_(x + (y >> 1) + 1) + 1) >> 1;
          else v = (T_(x + (y >> 1)) + 2 * T_(x + (y >> 1) + 1) + T_(x + (y >> 1) + 2) + 2) >> 2;
          break;
        default: {
          int z = x + 2 * y;
          if (z < 13 && !(z & 1)) v = (L_(y + (x >> 1)) + L_(y + (x >> 1) + 1) + 1) >> 1;
          else if (z < 13) v = (L_(y + (x >> 1)) + 2 * L_(y + (x >> 1) + 1) + L_(y + (x >> 1) + 2) + 2) >> 2;
          else if (z == 13) v = (L_(6) + 3 * L_(7) + 2) >> 2;
          else v = L_(7);
        }
      }
      P[y * 8 + x] = v;
    }
#undef T_
#undef L_
}

__device__ __noinline__ void intra_mb(const Pic& P, int mb, const int32_t* row, const int16_t* lv, const int* res, const int* resc) {
  int t = row[F_TYPE];
  int mx = mb % P.mbw, my = mb / P.mbw;
  int X = 16 * mx, Yp = 16 * my;
  uint8_t* Y = P.Y;
  int ys = P.ys, cs = P.cs;
  if (t == T_PCM) {
    for (int i = 0; i < 256; i++) Y[(Yp + i / 16) * ys + X + i % 16] = (uint8_t)(lv[i] & 0xFF);
    if (P.chroma)
      for (int i = 0; i < 64; i++) {
        P.U[(Yp / 2 + i / 8) * cs + X / 2 + i % 8] = (uint8_t)(lv[256 + i] & 0xFF);
        P.V[(Yp / 2 + i / 8) * cs + X / 2 + i % 8] = (uint8_t)(lv[320 + i] & 0xFF);
      }
    return;
  }
  int A = mb_ok_intra(P, mb, mx > 0 ? mb - 1 : -1);
  int Bn = mb_ok_intra(P, mb, my > 0 ? mb - P.mbw : -1);
  int C = mb_ok_intra(P, mb, (my > 0 && mx < P.mbw - 1) ? mb - P.mbw + 1 : -1);
  int D = mb_ok_intra(P, mb, (my > 0 && mx > 0) ? mb - P.mbw - 1 : -1);
  if (t == T_I16) {
    int mode = row[F_I16];
    int top[16], left[16], tl = D ? Y[(Yp - 1) * ys + X - 1] : 0;
    for (int k = 0; k < 16; k++) {
      top[k] = Bn ? Y[(Yp - 1) * ys + X + k] : 0;
      left[k] = A ? Y[(Yp + k) * ys + X - 1] : 0;
    }
    int dc = 128, a = 0, b = 0, c = 0;
    if (mode == 2) {
      int st = 0, sl = 0;
      for (int k = 0; k < 16; k++) { st += top[k]; sl += left[k]; }
      if (Bn && A) dc = (st + sl + 16) >> 5;
      else if (A) dc = (sl + 8) >> 4;
      else if (Bn) dc = (st + 8) >> 4;
    } else if (mode == 3) {
      int H = 0, V = 0;
      for (int k = 0; k < 8; k++) {
        H += (k + 1) * (top[8 + k] - (k < 7 ? top[6 - k] : tl));
        V += (k + 1) * (left[8 + k] - (k < 7 ? left[6 - k] : tl));
      }
      a = 16 * (left[15] + top[15]);
      b = (5 * H + 32) >> 6;
      c = (5 * V + 32) >> 6;
    }
    for (int y = 0; y < 16; y++)
      for (int x = 0; x < 16; x++) {
        int p = mode == 0 ? top[x] : (mode == 1 ? left[y] : (mode == 2 ? dc : clip1((a + b * (x - 7) + c * (y - 7) + 16) >> 5)));
        Y[(Yp + y) * ys + X + x] = (uint8_t)clip1(p + res[y * 16 + x]);
      }
  } else if (t == T_I4) {
    for (int b = 0; b < 16; b++) {
      int bx = blk_x(b), by = blk_y(b), x = X + 4 * bx, y = Yp + 4 * by;
      int mode = (row[b < 8 ? F_IM0 : F_IM1] >> (4 * (b & 7))) & 15;
      int has_top = by > 0 || Bn, has_left = bx > 0 || A;
      int has_tl = (by > 0 && bx > 0) ? 1 : (by > 0 ? A : (bx > 0 ? Bn : D));
      int has_tr = by == 0 ? (bx < 3 ? Bn : C) : (bx < 3 && blk_at(by - 1, bx + 1) < b);
      int top[8], left[4], tl = has_tl ? Y[(y - 1) * ys + x - 1] : 0;
      for (int k = 0; k < 4; k++) {
        top[k] = has_top ? Y[(y - 1) * ys + x + k] : 0;
        left[k] = has_left ? Y[(y + k) * ys + x - 1] : 0;
      }
      for (int k = 4; k < 8; k++) top[k] = has_top ? (has_tr ? Y[(y - 1) * ys + x + k] : top[3]) : 0;
      int Pr[16];
      intra4(mode, top, left, tl, has_top, has_left, Pr);
      for (int yy = 0; yy < 4; yy++)
        for (int xx = 0; xx < 4; xx++)
          Y[(y + yy) * ys + x + xx] = (uint8_t)clip1(Pr[yy * 4 + xx] + res[(4 * by + yy) * 16 + 4 * bx + xx]);
    }
  } else if (t == T_I8) {
    for (int k = 0; k < 4; k++) {
      int bx = k & 1, by = k >> 1, x = X + 8 * bx, y = Yp + 8 * by;
      int mode = (row[k < 2 ? F_IM0 : F_IM1] >> (16 * (k & 1))) & 15;
      int has_top = by > 0 || Bn, has_left = bx > 0 || A;
      int has_tl = (bx && by) ? 1 : (by ? A : (bx ? Bn : D));
      int has_tr = by == 0 ? (bx == 0 ? Bn : C) : (bx == 0);
      int top[16], left[8], tl = has_tl ? Y[(y - 1) * ys + x - 1] : 0;
      for (int q = 0; q < 8; q++) {
        top[q] = has_top ? Y[(y - 1) * ys + x + q] : 0;
        left[q] = has_left ? Y[(y + q) * ys + x - 1] : 0;
      }
      for (int q = 8; q < 16; q++) top[q] = has_top ? (has_tr ? Y[(y - 1) * ys + x + q] : top[7]) : 0;
      int Pr[64];
      intra8(mode, top, left, tl, has_top, has_left, has_tl, Pr);
      for (int yy = 0; yy < 8; yy++)
        for (int xx = 0; xx < 8; xx++)
          Y[(y + yy) * ys + x + xx] = (uint8_t)clip1(Pr[yy * 8 + xx] + res[(8 * by + yy) * 16 + 8 * bx + xx]);
    }
  }
  if (!P.chroma) return;
  int mode = row[F_CPRED], cx = X / 2, cy = Yp / 2;
  for (int comp = 0; comp < 2; comp++) {
    uint8_t* pl = comp ? P.V : P.U;
    int top[8], left[8], tl = D ? pl[(cy - 1) * cs + cx - 1] : 0;
    for (int k = 0; k < 8; k++) {
      top[k] = Bn ? pl[(cy - 1) * cs + cx + k] : 0;
      left[k] = A ? pl[(cy + k) * cs + cx - 1] : 0;
    }
    int a = 0, b = 0, c = 0;
    if (mode == 3) {
      int H = 0, V = 0;
      for (int k = 0; k < 4; k++) {
        H += (k + 1) * (top[4 + k] - (k < 3 ? top[2 - k] : tl));
        V += (k + 1) * (left[4 + k] - (k < 3 ? left[2 - k] : tl));
      }
      a = 16 * (left[7] + top[7]);
      b = (34 * H + 32) >> 6;
      c = (34 * V + 32) >> 6;
    }
    for (int by = 0; by < 2; by++)
      for (int bx = 0; bx < 2; bx++) {
        int dc = 128;
        if (mode == 0) {
          int st = 0, sl = 0;
          for (int k = 0; k < 4; k++) { st += top[4 * bx + k]; sl += left[4 * by + k]; }
          if ((bx == 0 && by == 0) || (bx == 1 && by == 1)) {
            if (Bn && A) dc = (st + sl + 4) >> 3;
            else if (A) dc = (sl + 2) >> 2;
            else if (Bn) dc = (st + 2) >> 2;
          } else if (bx == 1) {
            dc = Bn ? (st + 2) >> 2 : (A ? (sl + 2) >> 2 : 128);
          } else {
            dc = A ? (sl + 2) >> 2 : (Bn ? (st + 2) >> 2 : 128);
          }
        }
        for (int y = 4 * by; y < 4 * by + 4; y++)
          for (int x = 4 * bx; x < 4 * bx + 4; x++) {
            int p = mode == 0 ? dc : (mode == 1 ? left[y] : (mode == 2 ? top[x] : clip1((a + b * (x - 3) + c * (y - 3) + 16) >> 5)));
            pl[(cy + y) * cs + cx + x] = (uint8_t)clip1(p + resc[comp * 64 + y * 8 + x]);
          }
      }
  }
}

__device__ __noinline__ void inter_mb(const Pic& P, int mb, const int32_t* row, const int32_t* rec, const int* res, const int* resc) {
  int mx = mb % P.mbw, my = mb / P.mbw;
  int W = 16 * P.mbw, H = 16 * P.mbh;
  for (int b = 0; b < 16; b++) {
    int x4 = 4 * mx + blk_x(b), y4 = 4 * my + blk_y(b);
    int64_t i0 = ((int64_t)0 * P.h4 + y4) * P.w4 + x4, i1 = ((int64_t)1 * P.h4 + y4) * P.w4 + x4;
    int r0 = P.ref[i0], r1 = P.ref[i1];
    int use[2] = {r0 >= 0, r1 >= 0};
    int py[2][16], pc[2][2][4];
    for (int lx = 0; lx < 2; lx++) {
      if (!use[lx]) continue;
      int64_t i = lx ? i1 : i0;
      int r = lx ? r1 : r0;
      int slot = rec[R_SLOT + 32 * lx + r];
      const uint8_t* ry = (const uint8_t*)P.refs[3 * slot];
      int mvx = P.mv[2 * i], mvy = P.mv[2 * i + 1];
      luma_pred4(ry, P.ys, W, H, 4 * x4, 4 * y4, mvx, mvy, py[lx]);
      if (P.chroma) {
        chroma_pred2((const uint8_t*)P.refs[3 * slot + 1], P.cs, W / 2, H / 2, 2 * x4, 2 * y4, mvx, mvy, pc[lx][0]);
        chroma_pred2((const uint8_t*)P.refs[3 * slot + 2], P.cs, W / 2, H / 2, 2 * x4, 2 * y4, mvx, mvy, pc[lx][1]);
      }
    }
    int mode = rec[R_WEIGHTED];
    for (int plane = 0; plane < (P.chroma ? 3 : 1); plane++) {
      int w0 = 0, o0 = 0, w1 = 0, o1 = 0, denom = 0;
      if (mode == 1) {
        denom = plane == 0 ? rec[R_LDENOM] : rec[R_CDENOM];
        if (use[0]) { w0 = rec[R_WEIGHTS + r0 * 6 + 2 * plane]; o0 = rec[R_WEIGHTS + r0 * 6 + 2 * plane + 1]; }
        if (use[1]) { w1 = rec[R_WEIGHTS + 192 + r1 * 6 + 2 * plane]; o1 = rec[R_WEIGHTS + 192 + r1 * 6 + 2 * plane + 1]; }
      } else if (mode == 2 && use[0] && use[1]) {
        w1 = rec[R_IMPLICIT + r0 * 32 + r1];
        w0 = 64 - w1;
        denom = 5;
      }
      if (plane == 0) {
        for (int yy = 0; yy < 4; yy++)
          for (int xx = 0; xx < 4; xx++) {
            int p = weigh(py[0][yy * 4 + xx], py[1][yy * 4 + xx], use[0], use[1], w0, o0, w1, o1, denom, mode);
            P.Y[(4 * y4 + yy) * P.ys + 4 * x4 + xx] = (uint8_t)clip1(p + res[(4 * blk_y(b) + yy) * 16 + 4 * blk_x(b) + xx]);
          }
      } else {
        uint8_t* pl = plane == 1 ? P.U : P.V;
        for (int yy = 0; yy < 2; yy++)
          for (int xx = 0; xx < 2; xx++) {
            int p = weigh(pc[0][plane - 1][yy * 2 + xx], pc[1][plane - 1][yy * 2 + xx], use[0], use[1], w0, o0, w1, o1,
                          denom, mode);
            pl[(2 * y4 + yy) * P.cs + 2 * x4 + xx] =
                (uint8_t)clip1(p + resc[(plane - 1) * 64 + (2 * blk_y(b) + yy) * 8 + 2 * blk_x(b) + xx]);
          }
      }
    }
  }
}

__global__ void h264_recon_kernel(Pic P) {
  int waves = P.mbw + 2 * (P.mbh - 1);
  for (int w = 0; w < waves; w++) {
    for (int my = threadIdx.x; my < P.mbh; my += blockDim.x) {
      int mx = w - 2 * my;
      if (mx < 0 || mx >= P.mbw) continue;
      int mb = my * P.mbw + mx;
      const int32_t* row = P.tab + (int64_t)mb * N_FIELDS;
      const int16_t* lv = P.lev + (int64_t)mb * N_LEVELS;
      const int32_t* rec = P.rec + (int64_t)row[F_SLICE] * R_SIZE;
      Mv M;
      M.P = &P;
      M.mb = mb;
      M.slice = row[F_SLICE];
      M.mbx4 = 4 * mx;
      M.mby4 = 4 * my;
      M.done = 0;
      for (int lx = 0; lx < 2; lx++)  // no references until derived (intra: none)
        for (int b = 0; b < 16; b++) M.store(b, lx, -1, 0, 0, -1);
      derive_mb(P, mb, row, rec, M);
      int res[256], resc[128];
      residual_mb(P, row, lv, rec, res, resc);
      if (row[F_TYPE] <= T_PCM) intra_mb(P, mb, row, lv, res, resc);
      else inter_mb(P, mb, row, rec, res, resc);
    }
    __syncthreads();
  }
}

// ================================================================== deblocking

struct Db {
  const int32_t* tab;
  const int32_t* rec;
  const int32_t *mv, *rid;
  const int32_t* T;
  uint8_t *Y, *U, *V;
  int mbw, mbh, chroma, ys, cs, w4, h4;
};

__device__ int far4(const int32_t* mv, int64_t a, int64_t b) {
  return iabs(mv[2 * a] - mv[2 * b]) >= 4 || iabs(mv[2 * a + 1] - mv[2 * b + 1]) >= 4;
}

__device__ int check_mv(const Db& D, int py, int px, int qy, int qx) {
  int64_t n = (int64_t)D.h4 * D.w4;
  int64_t p0 = (int64_t)py * D.w4 + px, q0 = (int64_t)qy * D.w4 + qx, p1 = p0 + n, q1 = q0 + n;
  int rp0 = D.rid[p0], rp1 = D.rid[p1], rq0 = D.rid[q0], rq1 = D.rid[q1];
  int v = rp0 != rq0;
  if (!v && rp0 != -1) v = far4(D.mv, p0, q0);
  if (!v) v = rp1 != rq1 || far4(D.mv, p1, q1);
  if (v) {
    if (rp0 != rq1 || rp1 != rq0) return 1;
    return far4(D.mv, p0, q1) || far4(D.mv, p1, q0);
  }
  return 0;
}

__device__ void filter_line(uint8_t* s, int step, int bs, int alpha, int beta, const int* tc0, int chroma) {
  int p0 = s[-step], p1 = s[-2 * step], q0 = s[0], q1 = s[step];
  if (!(bs > 0 && iabs(p0 - q0) < alpha && iabs(p1 - p0) < beta && iabs(q1 - q0) < beta)) return;
  int p2 = chroma ? 0 : s[-3 * step], q2 = chroma ? 0 : s[2 * step];
  if (bs < 4) {
    int t0 = tc0[bs - 1];
    int ap = iabs(p2 - p0), aq = iabs(q2 - q0);
    int tc = chroma ? t0 + 1 : t0 + (ap < beta) + (aq < beta);
    int delta = clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
    s[-step] = (uint8_t)clip1(p0 + delta);
    s[0] = (uint8_t)clip1(q0 - delta);
    if (!chroma) {
      if (ap < beta) s[-2 * step] = (uint8_t)(p1 + clip3(-t0, t0, (p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1));
      if (aq < beta) s[step] = (uint8_t)(q1 + clip3(-t0, t0, (q2 + ((p0 + q0 + 1) >> 1) - (q1 << 1)) >> 1));
    }
    return;
  }
  if (chroma) {
    s[-step] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
    s[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
    return;
  }
  int p3 = s[-4 * step], q3 = s[3 * step];
  int ap = iabs(p2 - p0), aq = iabs(q2 - q0);
  int small = iabs(p0 - q0) < ((alpha >> 2) + 2);
  if (small && ap < beta) {
    s[-step] = (uint8_t)((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
    s[-2 * step] = (uint8_t)((p2 + p1 + p0 + q0 + 2) >> 2);
    s[-3 * step] = (uint8_t)((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
  } else {
    s[-step] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
  }
  if (small && aq < beta) {
    s[0] = (uint8_t)((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
    s[step] = (uint8_t)((p0 + q0 + q1 + q2 + 2) >> 2);
    s[2 * step] = (uint8_t)((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
  } else {
    s[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
  }
}

__device__ __noinline__ void deblock_mb(const Db& D, int mb) {
  const int32_t* row = D.tab + (int64_t)mb * N_FIELDS;
  const int32_t* rec = D.rec + (int64_t)row[F_SLICE] * R_SIZE;
  int idc = rec[R_DBIDC], aoff = rec[R_DBA], boff = rec[R_DBB];
  if (idc == 1) return;
  int mx = mb % D.mbw, my = mb / D.mbw;
  int t8 = row[F_T8];
  int qpq = row[F_TYPE] == T_PCM ? 0 : row[F_QP];
  for (int vert = 1; vert >= 0; vert--) {
    int nb = vert ? (mx > 0 ? mb - 1 : -1) : (my > 0 ? mb - D.mbw : -1);
    for (int edge = 0; edge < 4; edge++) {
      if (edge == 0) {
        if (nb < 0) continue;
        if (idc == 2 && D.tab[(int64_t)nb * N_FIELDS + F_SLICE] != row[F_SLICE]) continue;
      } else if (t8 && (edge & 1)) {
        continue;
      }
      int bs[4], any = 0;
      int pmb = edge == 0 ? nb : mb;
      const int32_t* prow = D.tab + (int64_t)pmb * N_FIELDS;
      for (int k = 0; k < 4; k++) {
        int qy = 4 * my + (vert ? k : edge), qx = 4 * mx + (vert ? edge : k);
        int py = vert ? qy : qy - 1, px = vert ? qx - 1 : qx;
        int v;
        if (row[F_TYPE] <= T_PCM || prow[F_TYPE] <= T_PCM) {
          v = edge == 0 ? 4 : 3;
        } else {
          int nzq = (row[F_NZ] >> blk_at(qy & 3, qx & 3)) & 1, nzp = (prow[F_NZ] >> blk_at(py & 3, px & 3)) & 1;
          v = (nzq || nzp) ? 2 : check_mv(D, py, px, qy, qx);
        }
        bs[k] = v;
        any |= v;
      }
      if (!any) continue;
      int qpp = prow[F_TYPE] == T_PCM ? 0 : prow[F_QP];
      int qav = (qpp + qpq + 1) >> 1;
      int ia = clip3(0, 51, qav + aoff), ib = clip3(0, 51, qav + boff);
      int alpha = D.T[O_ALPHA + ia], beta = D.T[O_BETA + ib];
      const int* tc0 = D.T + O_TC0 + 3 * ia;
      int X = 16 * mx + (vert ? 4 * edge : 0), Yy = 16 * my + (vert ? 0 : 4 * edge);
      for (int l = 0; l < 16; l++) {
        uint8_t* s = vert ? D.Y + (int64_t)(Yy + l) * D.ys + X : D.Y + (int64_t)Yy * D.ys + X + l;
        filter_line(s, vert ? 1 : D.ys, bs[l >> 2], alpha, beta, tc0, 0);
      }
      if (!D.chroma || (edge & 1)) continue;
      const int32_t* prec = D.rec + (int64_t)prow[F_SLICE] * R_SIZE;
      for (int comp = 0; comp < 2; comp++) {
        int qcp = D.T[O_CQP + clip3(0, 51, qpp + prec[R_CBOFF + comp])];
        int qcq = D.T[O_CQP + clip3(0, 51, qpq + rec[R_CBOFF + comp])];
        int qc = (qcp + qcq + 1) >> 1;
        int ca = clip3(0, 51, qc + aoff), cb = clip3(0, 51, qc + boff);
        int calpha = D.T[O_ALPHA + ca], cbeta = D.T[O_BETA + cb];
        const int* ctc0 = D.T + O_TC0 + 3 * ca;
        uint8_t* pl = comp ? D.V : D.U;
        int cx = 8 * mx + (vert ? 2 * edge : 0), cy = 8 * my + (vert ? 0 : 2 * edge);
        for (int l = 0; l < 8; l++) {
          uint8_t* s = vert ? pl + (int64_t)(cy + l) * D.cs + cx : pl + (int64_t)cy * D.cs + cx + l;
          filter_line(s, vert ? 1 : D.cs, bs[l >> 1], calpha, cbeta, ctc0, 1);
        }
      }
    }
  }
}

__global__ void h264_deblock_kernel(Db D) {
  int waves = D.mbw + 2 * (D.mbh - 1);
  for (int w = 0; w < waves; w++) {
    for (int my = threadIdx.x; my < D.mbh; my += blockDim.x) {
      int mx = w - 2 * my;
      if (mx < 0 || mx >= D.mbw) continue;
      deblock_mb(D, my * D.mbw + mx);
    }
    __syncthreads();
  }
}

int threads_for(int mbh) {
  int t = 32;
  while (t < mbh && t < 1024) t *= 2;
  return t < H264_MAX_THREADS ? t : H264_MAX_THREADS;
}

}  // namespace

extern "C" {

const char* dspnet_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int dspnet_h264_tables_size() { return N_TABLES; }
int dspnet_h264_record_size() { return R_SIZE; }

int dspnet_h264_recon(const void* tab, const void* lev, const void* rec, const void* refs, const void* tables, int mbw,
                      int mbh, int chroma, int poc, void* y, void* u, void* v, int ys, int cs, void* mv, void* ref,
                      void* rid, const void* cmv, const void* cref, const void* crid, void* stream) {
  Pic P;
  P.tab = (const int32_t*)tab;
  P.lev = (const int16_t*)lev;
  P.rec = (const int32_t*)rec;
  P.refs = (const int64_t*)refs;
  P.T = (const int32_t*)tables;
  P.mbw = mbw;
  P.mbh = mbh;
  P.chroma = chroma;
  P.poc = poc;
  P.ys = ys;
  P.cs = cs;
  P.Y = (uint8_t*)y;
  P.U = (uint8_t*)u;
  P.V = (uint8_t*)v;
  P.mv = (int32_t*)mv;
  P.ref = (int32_t*)ref;
  P.rid = (int32_t*)rid;
  P.cmv = (const int32_t*)cmv;
  P.cref = (const int32_t*)cref;
  P.crid = (const int32_t*)crid;
  P.w4 = 4 * mbw;
  P.h4 = 4 * mbh;
  H264_LAUNCH(h264_recon_kernel, 1, threads_for(mbh), (cudaStream_t)stream)(P);
  return (int)cudaGetLastError();
}

int dspnet_h264_deblock(const void* tab, const void* rec, const void* mv, const void* rid, const void* tables, int mbw,
                        int mbh, int chroma, void* y, void* u, void* v, int ys, int cs, void* stream) {
  Db D;
  D.tab = (const int32_t*)tab;
  D.rec = (const int32_t*)rec;
  D.mv = (const int32_t*)mv;
  D.rid = (const int32_t*)rid;
  D.T = (const int32_t*)tables;
  D.Y = (uint8_t*)y;
  D.U = (uint8_t*)u;
  D.V = (uint8_t*)v;
  D.mbw = mbw;
  D.mbh = mbh;
  D.chroma = chroma;
  D.ys = ys;
  D.cs = cs;
  D.w4 = 4 * mbw;
  D.h4 = 4 * mbh;
  H264_LAUNCH(h264_deblock_kernel, 1, threads_for(mbh), (cudaStream_t)stream)(D);
  return (int)cudaGetLastError();
}

}  // extern "C"
