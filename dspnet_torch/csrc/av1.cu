// AV1 intra decoding on the card: the reconstruction and the three loop
// filters of an AVIF image's frame, as four kernels; plain C interface.
//
// The counterpart of the JAX package's host decode, cv2.imdecode on libavif
// and libaom (dspnet_tpu/data/iterator.py:73,76; detect/detector.py:210,336):
// AV1 decoding is not a TPU kernel. The kernels replace libaom's
// av1_predict_intra_block with av1_inv_txfm2d_add (av1_recon_kernel),
// av1_filter_block_plane_vert / _horz (av1_deblock_kernel), av1_cdef_frame
// (av1_cdef_kernel) and av1_loop_restoration_filter_frame (av1_lr_kernel).
// The host (dspnet_torch/data/av1_parse.py) runs the entropy parse, which is
// serial per tile; the wrapper (dspnet_torch/data/av1_cuda.py) packs the
// transform-block table, the coefficients, the palettes, the filter tables
// and the constant tables into one buffer and copies it in on the caller's
// stream. Each kernel is held bit for bit to its plain version
// (av1_recon.reconstruct, av1_filters.deblock / cdef / loop_restore), which
// libaom 3.14 (and so cv2 5.0.0) equals on the committed forms.
//
// av1_recon_kernel: one launch per superblock wavefront (superblock (r, c)
// in wave c + lag * r; lag 2 for the above-right reach of intra
// prediction, 5 for 64x64 and 3 for 128x128 superblocks where IntraBC may
// read the frame, as libaom's av1_is_dv_valid wavefront allows), a thread
// block per superblock running its transform blocks in decode order: the
// prediction (edges, their filter and upsampling by one thread, then a
// thread a sample for directional, smooth, DC, Paeth, palette and CfL;
// filter intra by one thread; IntraBC as a bilinear copy), then the
// dequantisation (a thread a coefficient), the row transforms (a thread a
// row), the column transforms (a thread a column, libaom's rounding and
// clamps) and the add with clip (a thread a sample). What bounds it: the
// serial chain of transform blocks within a superblock and the waves.
//
// av1_deblock_kernel: one launch per direction, a thread per 4-sample edge
// segment of every plane (the host's edge table: position, filter length,
// level); filters of one pass never overlap, so it works in place.
//
// av1_cdef_kernel: a thread block per 64x64 luma block, each plane's region
// and a border of 3 staged in shared memory from the deblocked frame, a
// thread per 8x8 luma block for the direction search and then a thread per
// sample for the primary and secondary taps, into a second frame.
//
// av1_lr_kernel: a thread block per rectangle of one restoration unit and
// one 64-row stripe (the host's table), a thread per sample: the Wiener
// filter or the self-guided box filters and projection, reading the CDEF
// output inside the stripe and the deblocked frame's rows beyond it.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef AV1_LAUNCH
#define AV1_LAUNCH(kernel, grid, block, stream) kernel<<<(grid), (block), 0, (stream)>>>
#endif

namespace {

// transform-block table columns (av1_cuda.TXB_FIELDS)
enum {
  X_KIND, X_PLANE, X_X, X_Y, X_TX, X_TYPE, X_EOB, X_COEF, X_SCAN, X_FLAGS, X_MODE, X_FTYPE, X_ANGLE, X_FMODE,
  X_CFL, X_DCQ, X_ACQ, X_QM, X_DQSHIFT, X_W, X_H, X_MAXLW, X_MAXLH, X_MVR, X_MVC, X_PAL, X_MAP, X_MAPW, X_MAPX0,
  X_MAPY0, X_FIELDS
};
enum { KIND_INTRA = 0, KIND_RESIDUAL = 1, KIND_INTRABC = 2 };
enum { F_LEFT = 1, F_ABOVE = 2, F_ABOVE_RIGHT = 4, F_BELOW_LEFT = 8, F_CFL = 16, F_PALETTE = 32, F_FILTER = 64,
       F_LOSSLESS = 128 };
// constant tables (av1_cuda.TABLE_LAYOUT): offsets into one int32 buffer
struct Tables {
  const int* cospi;      // 64, cos_bit 12
  const int* sinpi;      // 5, cos_bit 12
  const int* fi_taps;    // 5 x 8 x 8
  const int* smooth;     // 124
  const int* dr_deriv;   // 90
  const int* mode_angle; // 13
  const int* scans;      // every scan, row-major positions
  const int* qm;         // 15 x 2 x 3344
  const int* inv_shift;  // 19 x 2
};
struct Frame {
  int* plane[3];
  int pitch[3];
  int max_x[3], max_y[3];  // last sample inside the mi grid
  int last_x[3], last_y[3];  // last sample inside the frame
  int bd, edge_filter, ssx, ssy;
};

__constant__ int kTxW[19] = {4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16, 8, 32, 16, 64};
__constant__ int kTxH[19] = {4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4, 32, 8, 64, 16};
// (vertical, horizontal) 1-D type of each transform type: 0 DCT, 1 ADST, 2 FLIPADST, 3 identity
__constant__ int kTx1d[16][2] = {{0, 0}, {1, 0}, {0, 1}, {1, 1}, {2, 0}, {0, 2}, {2, 2}, {1, 2},
                                 {2, 1}, {3, 3}, {0, 3}, {3, 0}, {1, 3}, {3, 1}, {2, 3}, {3, 2}};
__constant__ int kEdgeKernel[3][5] = {{0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }
__device__ __forceinline__ long long clampll(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
__device__ __forceinline__ int r12(long long x) { return (int)((x + 2048) >> 12); }
__device__ __forceinline__ int hbtf(int w0, int a, int w1, int b) {
  return r12((long long)w0 * a + (long long)w1 * b);
}
__device__ __forceinline__ int clamp_bits(long long v, int bits) {
  return (int)clampll(v, -(1LL << (bits - 1)), (1LL << (bits - 1)) - 1);
}
__device__ __forceinline__ int brev(int n, int x) {
  int r = 0;
  for (int i = 0; i < n; ++i)
    if (x & (1 << i)) r |= 1 << (n - 1 - i);
  return r;
}
__device__ __forceinline__ int log2i(int x) {
  int n = 0;
  while ((1 << (n + 1)) <= x) ++n;
  return n;
}

// ---------------------------------------------------------------- 1-D transforms

// the odd half of an n-point inverse DCT over o[0 .. n/2) (av1_recon._idct_odd)
__device__ void idct_odd(int* o, int n, const int* c, int rng) {
  const int m = n / 2;
  if (n == 4) {
    const int a = o[0], b = o[1];
    o[0] = hbtf(c[48], a, -c[16], b);
    o[1] = hbtf(c[16], a, c[48], b);
    return;
  }
  const int lg = log2i(m);
  for (int k = 0; k < m / 2; ++k) {
    const int q = (64 / n) * (2 * brev(lg, k) + 1);
    const int a = o[k], b = o[m - 1 - k];
    o[k] = hbtf(c[64 - q], a, -c[q], b);
    o[m - 1 - k] = hbtf(c[q], a, c[64 - q], b);
  }
  for (int level = 1; (1 << level) < m; ++level) {
    const int g = 1 << (level - 1);
    for (int t = 0; t < m / (2 * g); ++t) {
      const int s = t * 2 * g;
      for (int i = 0; i < g; ++i) {
        const int a = o[s + i], b = o[s + 2 * g - 1 - i];
        if (t % 2 == 0) {
          o[s + i] = clamp_bits((long long)a + b, rng);
          o[s + 2 * g - 1 - i] = clamp_bits((long long)a - b, rng);
        } else {
          o[s + i] = clamp_bits((long long)b - a, rng);
          o[s + 2 * g - 1 - i] = clamp_bits((long long)a + b, rng);
        }
      }
    }
    const int size = n >> (level + 1);
    const int blocks = max(1, (m / 2) / (4 * g));
    for (int t = 0; t < blocks; ++t) {
      const int s = t * 4 * g;
      const int q = size > 2 ? (64 / size) * (2 * brev(max(0, log2i(size / 2)), t) + 1) : 32;
      for (int i = 0; i < 2 * g; ++i) {
        const int p = s + g + i;
        if (p >= m / 2) break;
        const int mm = m - 1 - p;
        const int a = o[p], b = o[mm];
        if (i < g) {
          o[p] = hbtf(-c[q], a, c[64 - q], b);
          o[mm] = hbtf(c[64 - q], a, c[q], b);
        } else {
          o[p] = hbtf(-c[64 - q], a, -c[q], b);
          o[mm] = hbtf(-c[q], a, c[64 - q], b);
        }
      }
    }
  }
}

// inverse DCT of v[0 .. n) in place, inputs in natural order
__device__ void idct(int* v, int n, const int* c, int rng) {
  int b[64];
  const int lg = log2i(n);
  for (int i = 0; i < n; ++i) b[i] = v[brev(lg, i)];
  // bottom-up over the even halves: sizes 2, 4, .., n, each span's outputs
  // overwrite it (even part first, then the odd part of the next size)
  {
    const int a0 = b[0], a1 = b[1];
    b[0] = hbtf(c[32], a0, c[32], a1);
    b[1] = hbtf(c[32], a0, -c[32], a1);
  }
  for (int size = 4; size <= n; size *= 2) {
    const int half = size / 2;
    idct_odd(b + half, size, c, rng);
    int out[64];
    for (int i = 0; i < half; ++i) {
      out[i] = clamp_bits((long long)b[i] + b[half + half - 1 - i], rng);
      out[size - 1 - i] = clamp_bits((long long)b[i] - b[half + half - 1 - i], rng);
    }
    for (int i = 0; i < size; ++i) b[i] = out[i];
  }
  for (int i = 0; i < n; ++i) v[i] = b[i];
}

__device__ void iadst4(int* v, const int* s) {
  const long long x0 = v[0], x1 = v[1], x2 = v[2], x3 = v[3];
  long long s0 = s[1] * x0, s1 = s[2] * x0, s2 = s[3] * x1, s3 = s[4] * x2;
  const long long s4 = s[1] * x2, s5 = s[2] * x3, s6 = s[4] * x3;
  const long long s7 = (x0 - x2) + x3;
  s0 = s0 + s3;
  s1 = s1 - s4;
  s3 = s2;
  s2 = s[3] * s7;
  s0 = s0 + s5;
  s1 = s1 - s6;
  v[0] = r12(s0 + s3);
  v[1] = r12(s1 + s3);
  v[2] = r12(s2);
  v[3] = r12(s0 + s1 - s3);
}

__device__ void iadst8(int* v, const int* c, int rng) {
  int b[8] = {v[7], v[0], v[5], v[2], v[3], v[4], v[1], v[6]}, o[8];
  const int pq[4][2] = {{4, 60}, {20, 44}, {36, 28}, {52, 12}};
  for (int k = 0; k < 4; ++k) {
    const int p = pq[k][0], q = pq[k][1], a = b[2 * k], bb = b[2 * k + 1];
    o[2 * k] = hbtf(c[p], a, c[q], bb);
    o[2 * k + 1] = hbtf(c[q], a, -c[p], bb);
  }
  for (int i = 0; i < 4; ++i) {
    b[i] = clamp_bits((long long)o[i] + o[i + 4], rng);
    b[i + 4] = clamp_bits((long long)o[i] - o[i + 4], rng);
  }
  o[0] = b[0]; o[1] = b[1]; o[2] = b[2]; o[3] = b[3];
  o[4] = hbtf(c[16], b[4], c[48], b[5]);
  o[5] = hbtf(c[48], b[4], -c[16], b[5]);
  o[6] = hbtf(-c[48], b[6], c[16], b[7]);
  o[7] = hbtf(c[16], b[6], c[48], b[7]);
  for (int base = 0; base < 8; base += 4)
    for (int i = 0; i < 2; ++i) {
      b[base + i] = clamp_bits((long long)o[base + i] + o[base + i + 2], rng);
      b[base + i + 2] = clamp_bits((long long)o[base + i] - o[base + i + 2], rng);
    }
  for (int base = 2; base < 8; base += 4) {
    const int a = b[base], bb = b[base + 1];
    b[base] = hbtf(c[32], a, c[32], bb);
    b[base + 1] = hbtf(c[32], a, -c[32], bb);
  }
  v[0] = b[0]; v[1] = -b[4]; v[2] = b[6]; v[3] = -b[2]; v[4] = b[3]; v[5] = -b[7]; v[6] = b[5]; v[7] = -b[1];
}

__device__ void iadst16(int* v, const int* c, int rng) {
  int b[16] = {v[15], v[0], v[13], v[2], v[11], v[4], v[9], v[6], v[7], v[8], v[5], v[10], v[3], v[12], v[1], v[14]};
  int o[16];
  for (int k = 0; k < 8; ++k) {
    const int p = 2 + 8 * k, a = b[2 * k], bb = b[2 * k + 1];
    o[2 * k] = hbtf(c[p], a, c[64 - p], bb);
    o[2 * k + 1] = hbtf(c[64 - p], a, -c[p], bb);
  }
  for (int i = 0; i < 8; ++i) {
    b[i] = clamp_bits((long long)o[i] + o[i + 8], rng);
    b[i + 8] = clamp_bits((long long)o[i] - o[i + 8], rng);
  }
  for (int i = 0; i < 8; ++i) o[i] = b[i];
  o[8] = hbtf(c[8], b[8], c[56], b[9]);
  o[9] = hbtf(c[56], b[8], -c[8], b[9]);
  o[10] = hbtf(c[40], b[10], c[24], b[11]);
  o[11] = hbtf(c[24], b[10], -c[40], b[11]);
  o[12] = hbtf(-c[56], b[12], c[8], b[13]);
  o[13] = hbtf(c[8], b[12], c[56], b[13]);
  o[14] = hbtf(-c[24], b[14], c[40], b[15]);
  o[15] = hbtf(c[40], b[14], c[24], b[15]);
  for (int base = 0; base < 16; base += 8)
    for (int i = 0; i < 4; ++i) {
      b[base + i] = clamp_bits((long long)o[base + i] + o[base + i + 4], rng);
      b[base + i + 4] = clamp_bits((long long)o[base + i] - o[base + i + 4], rng);
    }
  for (int i = 0; i < 16; ++i) o[i] = b[i];
  for (int base = 4; base < 16; base += 8) {
    o[base] = hbtf(c[16], b[base], c[48], b[base + 1]);
    o[base + 1] = hbtf(c[48], b[base], -c[16], b[base + 1]);
    o[base + 2] = hbtf(-c[48], b[base + 2], c[16], b[base + 3]);
    o[base + 3] = hbtf(c[16], b[base + 2], c[48], b[base + 3]);
  }
  for (int base = 0; base < 16; base += 4)
    for (int i = 0; i < 2; ++i) {
      b[base + i] = clamp_bits((long long)o[base + i] + o[base + i + 2], rng);
      b[base + i + 2] = clamp_bits((long long)o[base + i] - o[base + i + 2], rng);
    }
  for (int base = 2; base < 16; base += 4) {
    const int a = b[base], bb = b[base + 1];
    b[base] = hbtf(c[32], a, c[32], bb);
    b[base + 1] = hbtf(c[32], a, -c[32], bb);
  }
  const int order[16] = {0, 8, 12, 4, 6, 14, 10, 2, 3, 11, 15, 7, 5, 13, 9, 1};
  for (int i = 0; i < 16; ++i) v[i] = (i & 1) ? -b[order[i]] : b[order[i]];
}

__device__ void iidentity(int* v, int n) {
  for (int i = 0; i < n; ++i) {
    if (n == 4) v[i] = r12((long long)v[i] * 5793);
    else if (n == 8) v[i] = v[i] * 2;
    else if (n == 16) v[i] = r12((long long)v[i] * 2 * 5793);
    else v[i] = v[i] * 4;
  }
}

__device__ void txfm_1d(int* v, int kind, int n, const Tables& t, int rng) {
  if (kind == 3) iidentity(v, n);
  else if (kind == 0) idct(v, n, t.cospi, rng);
  else if (n == 4) iadst4(v, t.sinpi);
  else if (n == 8) iadst8(v, t.cospi, rng);
  else iadst16(v, t.cospi, rng);
}

// ---------------------------------------------------------------- intra prediction

__device__ int edge_strength(int w, int h, int ftype, int delta) {
  const int d = abs(delta), wh = w + h;
  if (ftype == 0) {
    if (wh <= 8) return d >= 56 ? 1 : 0;
    if (wh <= 16) return d >= 40 ? 1 : 0;
    if (wh <= 24) return d >= 32 ? 3 : d >= 16 ? 2 : d >= 8 ? 1 : 0;
    if (wh <= 32) return d >= 32 ? 3 : d >= 4 ? 2 : d >= 1 ? 1 : 0;
    return d >= 1 ? 3 : 0;
  }
  if (wh <= 8) return d >= 64 ? 2 : d >= 40 ? 1 : 0;
  if (wh <= 16) return d >= 48 ? 2 : d >= 20 ? 1 : 0;
  if (wh <= 24) return d >= 4 ? 3 : 0;
  return d >= 1 ? 3 : 0;
}

// intra_edge_filter over e[0 .. sz) (e[0] the corner)
__device__ void edge_filter(int* e, int sz, int strength) {
  if (!strength) return;
  int src[300];
  for (int i = 0; i < sz; ++i) src[i] = e[i];
  const int* k = kEdgeKernel[strength - 1];
  for (int i = 1; i < sz; ++i) {
    int s = 0;
    for (int j = 0; j < 5; ++j) s += k[j] * src[clampi(i - 2 + j, 0, sz - 1)];
    e[i] = (s + 8) >> 4;
  }
}

__device__ bool upsample_use(int w, int h, int ftype, int delta) {
  const int d = abs(delta);
  if (d <= 0 || d >= 40) return false;
  return ftype ? (w + h <= 8) : (w + h <= 16);
}

// intra_edge_upsample: e holds buf[-1 .. num-1] at 0 .. num; afterwards
// buf[-2 .. 2 num - 2] at 0 .. 2 num
__device__ void edge_upsample(int* e, int num, int bd) {
  int dup[80];
  dup[0] = e[0];
  for (int i = 0; i <= num; ++i) dup[i + 1] = e[i];
  dup[num + 2] = e[num];
  const int mx = (1 << bd) - 1;
  e[0] = dup[0];
  for (int i = 0; i < num; ++i) {
    const int s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
    e[2 * i + 1] = clampi((s + 8) >> 4, 0, mx);
    e[2 * i + 2] = dup[i + 2];
  }
}

struct Pred {
  int A[300], L[300];  // above / left edges, corner at 0 (after upsampling: buf[-2] at 0)
  int oa, ol, n, dc, pangle, dx, dy, upa, upl;
  int lavg;
};

// thread 0: the edges of one transform block and the per-block constants
__device__ void prepare_edges(Pred& P, const Frame& F, const int* X, const Tables& t) {
  const int p = X[X_PLANE], x = X[X_X], y = X[X_Y], w = kTxW[X[X_TX]], h = kTxH[X[X_TX]];
  const int flags = X[X_FLAGS], mode = X[X_MODE];
  const int* fr = F.plane[p];
  const int pitch = F.pitch[p], bd = F.bd, mid = 1 << (bd - 1);
  const bool left = flags & F_LEFT, above = flags & F_ABOVE;
  const int n = w + h;
  P.n = n;
  int corner;
  if (above && left) corner = fr[(y - 1) * pitch + x - 1];
  else if (above) corner = fr[(y - 1) * pitch + x];
  else if (left) corner = fr[y * pitch + x - 1];
  else corner = mid;
  P.A[0] = P.L[0] = corner;
  if (!above && left) {
    for (int i = 0; i < n; ++i) P.A[i + 1] = fr[y * pitch + x - 1];
  } else if (!above) {
    for (int i = 0; i < n; ++i) P.A[i + 1] = mid - 1;
  } else {
    const int lim = min(F.max_x[p], x + ((flags & F_ABOVE_RIGHT) ? 2 * w : w) - 1);
    for (int i = 0; i < n; ++i) P.A[i + 1] = fr[(y - 1) * pitch + min(lim, x + i)];
  }
  if (!left && above) {
    for (int i = 0; i < n; ++i) P.L[i + 1] = fr[(y - 1) * pitch + x];
  } else if (!left) {
    for (int i = 0; i < n; ++i) P.L[i + 1] = mid + 1;
  } else {
    const int lim = min(F.max_y[p], y + ((flags & F_BELOW_LEFT) ? 2 * h : h) - 1);
    for (int i = 0; i < n; ++i) P.L[i + 1] = fr[min(lim, y + i) * pitch + x - 1];
  }
  P.oa = P.ol = 1;
  P.upa = P.upl = 0;
  if (flags & (F_PALETTE | F_FILTER)) return;
  if (mode >= 1 && mode <= 8) {
    const int pa = t.mode_angle[mode] + X[X_ANGLE] * 3;
    P.pangle = pa;
    const int ftype = X[X_FTYPE];
    if (F.edge_filter) {
      if (pa != 90 && pa != 180) {
        if (pa > 90 && pa < 180 && w + h >= 24) {
          const int c = (P.L[1] * 5 + corner * 6 + P.A[1] * 5 + 8) >> 4;
          P.A[0] = P.L[0] = c;
        }
        if (above) edge_filter(P.A, min(w, F.max_x[p] - x + 1) + (pa < 90 ? h : 0) + 1, edge_strength(w, h, ftype, pa - 90));
        if (left) edge_filter(P.L, min(h, F.max_y[p] - y + 1) + (pa > 180 ? w : 0) + 1, edge_strength(w, h, ftype, pa - 180));
      }
      if (upsample_use(w, h, ftype, pa - 90)) {
        edge_upsample(P.A, w + (pa < 90 ? h : 0), bd);
        P.upa = 1;
      }
      if (upsample_use(w, h, ftype, pa - 180)) {
        edge_upsample(P.L, h + (pa > 180 ? w : 0), bd);
        P.upl = 1;
      }
    }
    P.oa = 1 + P.upa;
    P.ol = 1 + P.upl;
    if (pa < 90) P.dx = t.dr_deriv[pa];
    else if (pa > 90 && pa < 180) { P.dx = t.dr_deriv[180 - pa]; P.dy = t.dr_deriv[pa - 90]; }
    else if (pa > 180) P.dy = t.dr_deriv[270 - pa];
  } else if (mode == 0) {  // DC
    long long s = 0;
    int avg;
    if (left && above) {
      for (int i = 0; i < w; ++i) s += P.A[i + 1];
      for (int i = 0; i < h; ++i) s += P.L[i + 1];
      avg = (int)((s + ((w + h) >> 1)) / (w + h));
    } else if (left) {
      for (int i = 0; i < h; ++i) s += P.L[i + 1];
      avg = (int)((s + (h >> 1)) >> log2i(h));
    } else if (above) {
      for (int i = 0; i < w; ++i) s += P.A[i + 1];
      avg = (int)((s + (w >> 1)) >> log2i(w));
    } else {
      avg = mid;
    }
    P.dc = avg;
  }
}

// one predicted sample (i, j) of a non-filter-intra, non-palette block
__device__ int predict_sample(const Pred& P, const int* X, const Tables& t, int i, int j, int w, int h) {
  const int mode = X[X_MODE];
  const int* A = P.A + P.oa;  // A[k] is AboveRow[k]
  const int* L = P.L + P.ol;
  if (mode >= 1 && mode <= 8) {
    const int pa = P.pangle;
    if (pa == 90) return A[j];
    if (pa == 180) return L[i];
    if (pa < 90) {
      const int idx = (i + 1) * P.dx;
      const int base = (idx >> (6 - P.upa)) + (j << P.upa);
      const int shift = ((idx << P.upa) >> 1) & 0x1F;
      const int max_base = (w + h - 1) << P.upa;
      if (base >= max_base) return A[max_base];
      return (A[base] * (32 - shift) + A[base + 1] * shift + 16) >> 5;
    }
    if (pa > 180) {
      const int idx = (j + 1) * P.dy;
      const int base = (idx >> (6 - P.upl)) + (i << P.upl);
      const int shift = ((idx << P.upl) >> 1) & 0x1F;
      const int max_base = (w + h - 1) << P.upl;
      if (base >= max_base) return L[max_base];
      return (L[base] * (32 - shift) + L[base + 1] * shift + 16) >> 5;
    }
    const int idx = (j << 6) - (i + 1) * P.dx;
    const int base = idx >> (6 - P.upa);
    if (base >= -(1 << P.upa)) {
      const int shift = ((idx << P.upa) >> 1) & 0x1F;
      return (A[base] * (32 - shift) + A[base + 1] * shift + 16) >> 5;
    }
    const int idy = (i << 6) - (j + 1) * P.dy;
    const int basey = idy >> (6 - P.upl);
    const int shifty = ((idy << P.upl) >> 1) & 0x1F;
    return (L[basey] * (32 - shifty) + L[basey + 1] * shifty + 16) >> 5;
  }
  if (mode == 0) return P.dc;
  if (mode >= 9 && mode <= 11) {
    const int* sw = t.smooth;
    const int ox = w == 4 ? 0 : w == 8 ? 4 : w == 16 ? 12 : w == 32 ? 28 : 60;
    const int oy = h == 4 ? 0 : h == 8 ? 4 : h == 16 ? 12 : h == 32 ? 28 : 60;
    const int wx = sw[ox + j], wy = sw[oy + i];
    if (mode == 9) return (wy * A[j] + (256 - wy) * L[h - 1] + wx * L[i] + (256 - wx) * A[w - 1] + 256) >> 9;
    if (mode == 10) return (wy * A[j] + (256 - wy) * L[h - 1] + 128) >> 8;
    return (wx * L[i] + (256 - wx) * A[w - 1] + 128) >> 8;
  }
  // Paeth
  const int corner = P.A[0];
  const int base = A[j] + L[i] - corner;
  const int pl = abs(base - L[i]), pt = abs(base - A[j]), ptl = abs(base - corner);
  if (pl <= pt && pl <= ptl) return L[i];
  if (pt <= ptl) return A[j];
  return corner;
}

// filter intra by one thread into dst (pitch w)
__device__ void filter_intra(const Pred& P, const int* X, const Tables& t, int* dst, int w, int h, int bd) {
  const int* taps = t.fi_taps + X[X_FMODE] * 64;
  const int mx = (1 << bd) - 1;
  const int* A = P.A + 1;
  const int* L = P.L + 1;
  for (int i2 = 0; i2 < (h >> 1); ++i2)
    for (int j4 = 0; j4 < (w >> 2); ++j4) {
      int p[7];
      for (int i = 0; i < 7; ++i) {
        if (i < 5) {
          if (i2 == 0) p[i] = (j4 << 2) + i - 1 < 0 ? P.A[0] : A[(j4 << 2) + i - 1];
          else if (j4 == 0 && i == 0) p[i] = L[(i2 << 1) - 1];
          else p[i] = dst[((i2 << 1) - 1) * w + (j4 << 2) + i - 1];
        } else {
          if (j4 == 0) p[i] = L[(i2 << 1) + i - 5];
          else p[i] = dst[((i2 << 1) + i - 5) * w + (j4 << 2) - 1];
        }
      }
      for (int i = 0; i < 8; ++i) {
        int pr = 0;
        for (int j = 0; j < 7; ++j) pr += taps[i * 8 + j] * p[j];
        const int v = pr >= 0 ? (pr + 8) >> 4 : -((-pr + 8) >> 4);
        dst[((i2 << 1) + (i >> 2)) * w + (j4 << 2) + (i & 3)] = clampi(v, 0, mx);
      }
    }
}

// ---------------------------------------------------------------- reconstruction

__global__ void av1_recon_kernel(Frame F, Tables T, const int* __restrict__ txbs, const int* __restrict__ sb_first,
                                 const int* __restrict__ sb_count, const int* __restrict__ wave_sbs, int wave_off,
                                 const int* __restrict__ coefs, const int* __restrict__ palette,
                                 const uint8_t* __restrict__ maps) {
  __shared__ int buf[64 * 64];
  __shared__ Pred P;
  __shared__ long long lsum;
  const int sb = wave_sbs[wave_off + blockIdx.x];
  const int first = sb_first[sb], count = sb_count[sb];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int bd = F.bd, mx = (1 << bd) - 1;
  for (int k = first; k < first + count; ++k) {
    const int* X = txbs + (size_t)k * X_FIELDS;
    const int kind = X[X_KIND], p = X[X_PLANE], x0 = X[X_X], y0 = X[X_Y];
    int* fr = F.plane[p];
    const int pitch = F.pitch[p];
    if (kind == KIND_INTRABC) {
      const int w = X[X_W], h = X[X_H];
      const int sx = p ? F.ssx : 0, sy = p ? F.ssy : 0;
      const int r0 = bd == 12 ? 5 : 3, r1 = bd == 12 ? 9 : 11;
      const int px = (x0 << 4) + ((2 * X[X_MVC]) >> sx), py = (y0 << 4) + ((2 * X[X_MVR]) >> sy);
      const int fx = px & 15, fy = py & 15, ix = px >> 4, iy = py >> 4;
      for (int e = tid; e < w * h; e += nt) {
        const int i = e / w, j = e % w;
        long long hx[2];
        for (int r = 0; r < 2; ++r) {
          const int yy = clampi(iy + i + r, 0, F.last_y[p]);
          const int a = fr[yy * pitch + clampi(ix + j, 0, F.last_x[p])];
          const int b = fr[yy * pitch + clampi(ix + j + 1, 0, F.last_x[p])];
          hx[r] = ((long long)a * (128 - 8 * fx) + (long long)b * (8 * fx) + (1 << (r0 - 1))) >> r0;
        }
        buf[e] = clampi((int)((hx[0] * (128 - 8 * fy) + hx[1] * (8 * fy) + (1 << (r1 - 1))) >> r1), 0, mx);
      }
      __syncthreads();
      for (int e = tid; e < w * h; e += nt) fr[(y0 + e / w) * pitch + x0 + e % w] = buf[e];
      __syncthreads();
      continue;
    }
    const int tx = X[X_TX], w = kTxW[tx], h = kTxH[tx], flags = X[X_FLAGS];
    if (kind == KIND_INTRA) {
      if (flags & F_PALETTE) {
        const int* pal = palette + X[X_PAL];
        const uint8_t* map = maps + X[X_MAP];
        const int mw = X[X_MAPW], mx0 = X[X_MAPX0], my0 = X[X_MAPY0];
        for (int e = tid; e < w * h; e += nt) {
          const int i = e / w, j = e % w;
          fr[(y0 + i) * pitch + x0 + j] = pal[map[(y0 - my0 + i) * mw + (x0 - mx0 + j)]];
        }
      } else {
        if (tid == 0) prepare_edges(P, F, X, T);
        __syncthreads();
        if (flags & F_FILTER) {
          if (tid == 0) filter_intra(P, X, T, buf, w, h, bd);
          __syncthreads();
          for (int e = tid; e < w * h; e += nt) fr[(y0 + e / w) * pitch + x0 + e % w] = buf[e];
        } else {
          for (int e = tid; e < w * h; e += nt) {
            const int i = e / w, j = e % w;
            fr[(y0 + i) * pitch + x0 + j] = predict_sample(P, X, T, i, j, w, h);
          }
        }
        if (flags & F_CFL) {
          __syncthreads();
          // CfL: the luma average of the co-located (subsampled) luma
          const int sx = F.ssx, sy = F.ssy;
          const int* luma = F.plane[0];
          const int lp = F.pitch[0];
          const int maxw = X[X_MAXLW], maxh = X[X_MAXLH];
          if (tid == 0) lsum = 0;
          __syncthreads();
          for (int e = tid; e < w * h; e += nt) {
            const int i = e / w, j = e % w;
            const int ly = min((y0 + i) << sy, maxh - (1 << sy)), lx = min((x0 + j) << sx, maxw - (1 << sx));
            int s = 0;
            for (int dy = 0; dy <= sy; ++dy)
              for (int dx = 0; dx <= sx; ++dx) s += luma[(ly + dy) * lp + lx + dx];
            buf[e] = s << (3 - sx - sy);
            atomicAdd((unsigned long long*)&lsum, (unsigned long long)(long long)buf[e]);
          }
          __syncthreads();
          const int sh = log2i(w) + log2i(h);
          const long long avg = (lsum + (1LL << (sh - 1))) >> sh;
          const int alpha = X[X_CFL];
          for (int e = tid; e < w * h; e += nt) {
            const int i = e / w, j = e % w;
            const long long d = (long long)alpha * (buf[e] - avg);
            const long long sc = d >= 0 ? (d + 32) >> 6 : -((-d + 32) >> 6);
            int* q = fr + (y0 + i) * pitch + x0 + j;
            *q = (int)clampll(*q + sc, 0, mx);
          }
        }
      }
      __syncthreads();
    }
    const int eob = X[X_EOB];
    if (eob <= 0) continue;
    // dequantise into buf (h x w, zero beyond)
    for (int e = tid; e < w * h; e += nt) buf[e] = 0;
    __syncthreads();
    const int tw = min(w, 32);
    const int* scan = T.scans + X[X_SCAN];
    const int* cf = coefs + X[X_COEF];
    const int dcq = X[X_DCQ], acq = X[X_ACQ], qm = X[X_QM], shift = X[X_DQSHIFT];
    const long long lim = 1LL << (7 + bd);
    for (int c = tid; c < eob; c += nt) {
      const int pos = scan[c];
      long long q = pos == 0 ? dcq : acq;
      if (qm >= 0) q = ((long long)T.qm[qm + pos] * q + 16) >> 5;
      const int v = cf[c];
      long long mag = (((long long)abs(v) * q) & 0xFFFFFF) >> shift;
      const long long d = v < 0 ? -mag : mag;
      buf[(pos / tw) * w + pos % tw] = (int)clampll(d, -lim, lim - 1);
    }
    __syncthreads();
    if (flags & F_LOSSLESS) {
      // inverse Walsh-Hadamard: rows with shift 2, then columns
      if (tid == 0) {
        for (int pass = 0; pass < 2; ++pass)
          for (int k2 = 0; k2 < 4; ++k2) {
            int v[4];
            for (int q2 = 0; q2 < 4; ++q2) v[q2] = pass == 0 ? buf[k2 * 4 + q2] : buf[q2 * 4 + k2];
            const int sh = pass == 0 ? 2 : 0;
            int a = v[0] >> sh, c2 = v[1] >> sh, d = v[2] >> sh, b = v[3] >> sh;
            a += c2; d -= b;
            const int e = (a - d) >> 1;
            b = e - b; c2 = e - c2; a -= b; d += c2;
            const int o[4] = {a, b, c2, d};
            for (int q2 = 0; q2 < 4; ++q2) (pass == 0 ? buf[k2 * 4 + q2] : buf[q2 * 4 + k2]) = o[q2];
          }
      }
      __syncthreads();
    } else {
      const int vt = kTx1d[X[X_TYPE]][0], ht = kTx1d[X[X_TYPE]][1];
      const int s0 = -T.inv_shift[tx * 2], s1 = -T.inv_shift[tx * 2 + 1];
      const int row_rng = bd + 8, col_rng = max(bd + 6, 16);
      const bool rect = abs(log2i(w) - log2i(h)) == 1;
      for (int i = tid; i < h; i += nt) {
        int v[64];
        for (int j = 0; j < w; ++j) {
          long long a = buf[i * w + j];
          if (rect) a = r12(a * 2896);
          v[j] = clamp_bits(a, row_rng);
        }
        txfm_1d(v, ht, w, T, row_rng);
        for (int j = 0; j < w; ++j) buf[i * w + j] = s0 ? (v[j] + (1 << (s0 - 1))) >> s0 : v[j];
      }
      __syncthreads();
      for (int j = tid; j < w; j += nt) {
        int v[64];
        const int jj = ht == 2 ? w - 1 - j : j;
        for (int i = 0; i < h; ++i) v[i] = clamp_bits(buf[i * w + jj], col_rng);
        txfm_1d(v, vt, h, T, col_rng);
        for (int i = 0; i < h; ++i) {
          const int r = (v[i] + (1 << (s1 - 1))) >> s1;
          const int ii = vt == 2 ? h - 1 - i : i;
          int* q = fr + (y0 + ii) * pitch + x0 + j;
          *q = clampi(*q + r, 0, mx);
        }
      }
      __syncthreads();
      continue;
    }
    for (int e = tid; e < w * h; e += nt) {
      int* q = fr + (y0 + e / w) * pitch + x0 + e % w;
      *q = clampi(*q + buf[e], 0, mx);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- deblocking

__global__ void av1_deblock_kernel(Frame F, const int* __restrict__ edges, int n_edges, int dir, int sharpness) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n_edges) return;
  const int* E = edges + (size_t)k * 5;
  const int p = E[0], ex = E[1], ey = E[2], length = E[3], level = E[4];
  int* fr = F.plane[p];
  const int pitch = F.pitch[p], bd = F.bd, sh = bd - 8;
  const int shift = sharpness > 4 ? 2 : sharpness > 0 ? 1 : 0;
  int lim = level >> shift;
  if (sharpness > 0) lim = min(lim, 9 - sharpness);
  lim = max(lim, 1);
  int blim = 2 * (level + 2) + lim;
  int thr = level >> 4;
  lim <<= sh; blim <<= sh; thr <<= sh;
  const int one = 1 << sh;
  const int lo = -(1 << (bd - 1)), hi = (1 << (bd - 1)) - 1, off = 0x80 << sh;
  for (int line = 0; line < 4; ++line) {
    int* base;
    int step;
    if (dir == 0) { base = fr + (ey + line) * pitch + ex; step = 1; }
    else { base = fr + ey * pitch + ex + line; step = pitch; }
    int P[7], Q[7];
    const int reach = length == 14 ? 7 : length == 8 ? 4 : length == 6 ? 3 : 2;
    for (int i = 0; i < 7; ++i) {
      P[i] = i < reach ? base[-(i + 1) * step] : 0;
      Q[i] = i < reach ? base[i * step] : 0;
    }
    const int hev = abs(P[1] - P[0]) > thr || abs(Q[1] - Q[0]) > thr;
    bool mask = abs(P[1] - P[0]) <= lim && abs(Q[1] - Q[0]) <= lim && abs(P[0] - Q[0]) * 2 + abs(P[1] - Q[1]) / 2 <= blim;
    if (length >= 6) mask = mask && abs(P[2] - P[1]) <= lim && abs(Q[2] - Q[1]) <= lim;
    if (length >= 8) mask = mask && abs(P[3] - P[2]) <= lim && abs(Q[3] - Q[2]) <= lim;
    if (!mask) continue;
    bool flat = false, flat2 = false;
    if (length >= 6) {
      flat = abs(P[1] - P[0]) <= one && abs(Q[1] - Q[0]) <= one && abs(P[2] - P[0]) <= one && abs(Q[2] - Q[0]) <= one;
      if (length >= 8) flat = flat && abs(P[3] - P[0]) <= one && abs(Q[3] - Q[0]) <= one;
    }
    if (length == 14)
      flat2 = abs(P[6] - P[0]) <= one && abs(Q[6] - Q[0]) <= one && abs(P[5] - P[0]) <= one &&
              abs(Q[5] - Q[0]) <= one && abs(P[4] - P[0]) <= one && abs(Q[4] - Q[0]) <= one;
    if (length == 4 || !flat) {
      const int ps1 = P[1] - off, ps0 = P[0] - off, qs0 = Q[0] - off, qs1 = Q[1] - off;
      int f = hev ? clampi(ps1 - qs1, lo, hi) : 0;
      f = clampi(f + 3 * (qs0 - ps0), lo, hi);
      const int f1 = clampi(f + 4, lo, hi) >> 3, f2 = clampi(f + 3, lo, hi) >> 3;
      base[0] = clampi(qs0 - f1, lo, hi) + off;
      base[-step] = clampi(ps0 + f2, lo, hi) + off;
      if (!hev) {
        const int f3 = (f1 + 1) >> 1;
        base[step] = clampi(qs1 - f3, lo, hi) + off;
        base[-2 * step] = clampi(ps1 + f3, lo, hi) + off;
      }
      continue;
    }
    int n, log2;
    if (length == 14 && flat2) { n = 6; log2 = 4; }
    else if (length == 6) { n = 2; log2 = 3; }
    else { n = 3; log2 = 3; }
    const int n2 = (log2 == 3 && n == 3) ? 0 : 1;
    int Fv[14];  // F[k] at k + 7, k = -7 .. 6
    for (int k2 = -7; k2 < 7; ++k2) Fv[k2 + 7] = k2 < 0 ? P[-k2 - 1] : Q[k2];
    int out[14];
    for (int i = -n; i < n; ++i) {
      int t = 0;
      for (int j = -n; j <= n; ++j) {
        const int pp = clampi(i + j, -(n + 1), n);
        t += Fv[pp + 7] * (abs(j) <= n2 ? 2 : 1);
      }
      out[i + 7] = (t + (1 << (log2 - 1))) >> log2;
    }
    for (int i = -n; i < n; ++i) base[i * step] = out[i + 7];
  }
}

// ---------------------------------------------------------------- CDEF

__constant__ int kCdefDir[8][2][2] = {{{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}, {{0, 1}, {0, 2}}, {{0, 1}, {1, 2}},
                                      {{1, 1}, {2, 2}}, {{1, 0}, {2, 1}}, {{1, 0}, {2, 0}}, {{1, 0}, {2, -1}}};
__constant__ int kDivTable[9] = {0, 840, 420, 280, 210, 168, 140, 120, 105};
#define CDEF_NA (-1000000)

struct CdefArgs {
  int damping, sh, uv_dir[8], nplanes;
  int y_pri[8], y_sec[8], uv_pri[8], uv_sec[8];
};

__device__ int constrain(int diff, int threshold, int damping) {
  if (!threshold) return 0;
  const int adj = max(0, damping - log2i(threshold));
  const int a = abs(diff);
  const int v = min(a, max(0, threshold - (a >> adj)));
  return diff < 0 ? -v : v;
}

__global__ void av1_cdef_kernel(Frame F, Frame O, const int8_t* __restrict__ cdef_idx, int idx_pitch,
                                const uint8_t* __restrict__ skip, int mi_rows, int mi_cols, CdefArgs a) {
  __shared__ int tile[70 * 70];
  __shared__ int dirs[64], vars[64], idxs[64];
  const int fbr = blockIdx.y, fbc = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int idx = cdef_idx[fbr * idx_pitch + fbc];
  if (idx < 0) return;
  const int bd = F.bd;
  if (tid < 64) {
    const int r = fbr * 16 + (tid >> 3) * 2, c = fbc * 16 + (tid & 7) * 2;
    bool on = r < mi_rows && c < mi_cols;
    if (on) {
      const bool sk = skip[r * mi_cols + c] && skip[(r + 1) * mi_cols + c] && skip[r * mi_cols + c + 1] &&
                      skip[(r + 1) * mi_cols + c + 1];
      on = !sk;
    }
    idxs[tid] = on ? 1 : 0;
  }
  for (int p = 0; p < a.nplanes; ++p) {
    const int sx = p ? F.ssx : 0, sy = p ? F.ssy : 0;
    const int bw = 64 >> sx, bh = 64 >> sy;
    const int x0 = (fbc * 64) >> sx, y0 = (fbr * 64) >> sy;
    const int H = (mi_rows * 4) >> sy, W = (mi_cols * 4) >> sx;
    const int tw = bw + 6;
    const int* src = F.plane[p];
    const int pitch = F.pitch[p];
    __syncthreads();
    for (int e = tid; e < (bh + 6) * tw; e += nt) {
      const int yy = y0 - 3 + e / tw, xx = x0 - 3 + e % tw;
      tile[e] = (yy >= 0 && yy < H && xx >= 0 && xx < W) ? src[yy * pitch + xx] : CDEF_NA;
    }
    __syncthreads();
    if (p == 0 && tid < 64 && idxs[tid]) {
      // cdef_find_dir on the 8x8 luma block
      const int by = (tid >> 3) * 8, bx = (tid & 7) * 8;
      long long partial[8][15];
      for (int d = 0; d < 8; ++d)
        for (int l = 0; l < 15; ++l) partial[d][l] = 0;
      for (int i = 0; i < 8; ++i)
        for (int j = 0; j < 8; ++j) {
          const int v = (tile[(by + i + 3) * tw + bx + j + 3] >> (bd - 8)) - 128;
          partial[0][i + j] += v;
          partial[1][i + j / 2] += v;
          partial[2][i] += v;
          partial[3][3 + i - j / 2] += v;
          partial[4][7 + i - j] += v;
          partial[5][3 - i / 2 + j] += v;
          partial[6][j] += v;
          partial[7][i / 2 + j] += v;
        }
      long long cost[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      for (int i = 0; i < 8; ++i) {
        cost[2] += partial[2][i] * partial[2][i];
        cost[6] += partial[6][i] * partial[6][i];
      }
      cost[2] *= kDivTable[8];
      cost[6] *= kDivTable[8];
      for (int i = 0; i < 7; ++i) {
        cost[0] += (partial[0][i] * partial[0][i] + partial[0][14 - i] * partial[0][14 - i]) * kDivTable[i + 1];
        cost[4] += (partial[4][i] * partial[4][i] + partial[4][14 - i] * partial[4][14 - i]) * kDivTable[i + 1];
      }
      cost[0] += partial[0][7] * partial[0][7] * kDivTable[8];
      cost[4] += partial[4][7] * partial[4][7] * kDivTable[8];
      for (int i = 1; i < 8; i += 2) {
        for (int j = 0; j < 5; ++j) cost[i] += partial[i][3 + j] * partial[i][3 + j];
        cost[i] *= kDivTable[8];
        for (int j = 0; j < 3; ++j)
          cost[i] += (partial[i][j] * partial[i][j] + partial[i][10 - j] * partial[i][10 - j]) * kDivTable[2 * j + 2];
      }
      long long best = 0;
      int bdir = 0;
      for (int i = 0; i < 8; ++i)
        if (cost[i] > best) { best = cost[i]; bdir = i; }
      dirs[tid] = bdir;
      vars[tid] = (int)((best - cost[(bdir + 4) & 7]) >> 10);
    }
    __syncthreads();
    int* dst = O.plane[p];
    const int opitch = O.pitch[p];
    const int ew = 8 >> sx, eh = 8 >> sy;
    for (int e = tid; e < 64 * ew * eh; e += nt) {
      const int b = e / (ew * eh), q = e % (ew * eh);
      if (!idxs[b]) continue;
      const int i = (b >> 3) * eh + q / ew, j = (b & 7) * ew + q % ew;
      if (y0 + i >= H || x0 + j >= W) continue;
      int pri, sec, damping, dir;
      if (p == 0) {
        pri = a.y_pri[idx] << a.sh;
        sec = a.y_sec[idx] << a.sh;
        const int var = vars[b];
        const int vs = (var >> 6) ? min(log2i(var >> 6), 12) : 0;
        dir = pri ? dirs[b] : 0;
        pri = var ? (pri * (4 + vs) + 8) >> 4 : 0;
        damping = a.damping + a.sh;
      } else {
        pri = a.uv_pri[idx] << a.sh;
        sec = a.uv_sec[idx] << a.sh;
        dir = pri ? a.uv_dir[dirs[b]] : 0;
        damping = a.damping + a.sh - 1;
      }
      const int pt0 = ((pri >> a.sh) & 1) ? 3 : 4, pt1 = ((pri >> a.sh) & 1) ? 3 : 2;
      const int x = tile[(i + 3) * tw + j + 3];
      int sum = 0, mxv = x, mnv = x;
      for (int k = 0; k < 2; ++k)
        for (int sign = -1; sign <= 1; sign += 2)
          for (int o = 0; o < 3; ++o) {
            const int dd = (dir + (o == 0 ? 0 : o == 1 ? -2 : 2)) & 7;
            const int v = tile[(i + 3 + sign * kCdefDir[dd][k][0]) * tw + j + 3 + sign * kCdefDir[dd][k][1]];
            if (v == CDEF_NA) continue;
            if (o == 0) sum += (k == 0 ? pt0 : pt1) * constrain(v - x, pri, damping);
            else sum += (k == 0 ? 2 : 1) * constrain(v - x, sec, damping);
            mxv = max(mxv, v);
            mnv = min(mnv, v);
          }
      dst[(y0 + i) * opitch + x0 + j] = clampi(x + ((8 + sum - (sum < 0)) >> 4), mnv, mxv);
    }
  }
}

// ---------------------------------------------------------------- loop restoration

// rect table columns (av1_cuda.LR_FIELDS)
enum { R_PLANE, R_X, R_Y, R_W, R_H, R_TYPE, R_S0, R_S1, R_C0, R_C1, R_C2, R_C3, R_C4, R_C5, R_SET, R_XQ0, R_XQ1,
       R_FIELDS };

__device__ __forceinline__ int lr_source(const Frame& D, const Frame& C, int p, int y, int x, int s0, int s1) {
  x = clampi(x, 0, D.last_x[p]);
  y = clampi(y, 0, D.last_y[p]);
  if (y < s0) return D.plane[p][max(s0 - 2, y) * D.pitch[p] + x];
  if (y > s1) return D.plane[p][min(s1 + 2, y) * D.pitch[p] + x];
  return C.plane[p][y * C.pitch[p] + x];
}

__device__ void box_ab(const Frame& D, const Frame& C, int p, int y, int x, int s0, int s1, int r, int s, int bd,
                       const int* x_by_xplus1, const int* one_by_x, int* A, int* B) {
  const int n = (2 * r + 1) * (2 * r + 1);
  long long a = 0, b = 0;
  for (int dy = -r; dy <= r; ++dy)
    for (int dx = -r; dx <= r; ++dx) {
      const int c = lr_source(D, C, p, y + dy, x + dx, s0, s1);
      a += (long long)c * c;
      b += c;
    }
  long long pp;
  if (bd > 8) {
    const long long a2 = (a + (1LL << (2 * (bd - 8) - 1))) >> (2 * (bd - 8));
    const long long d = (b + (1LL << (bd - 9))) >> (bd - 8);
    pp = a2 * n - d * d;
    if (pp < 0) pp = 0;
  } else {
    pp = a * n - b * b;
  }
  const long long z = (pp * s + (1LL << 19)) >> 20;
  const int av = x_by_xplus1[z < 255 ? z : 255];
  *A = av;
  *B = (int)(((long long)(256 - av) * b * one_by_x[n - 1] + (1 << 11)) >> 12);
}

__global__ void av1_lr_kernel(Frame D, Frame C, Frame O, const int* __restrict__ rects, const int* __restrict__ sgr,
                              const int* __restrict__ x_by_xplus1, const int* __restrict__ one_by_x) {
  const int* R = rects + (size_t)blockIdx.x * R_FIELDS;
  const int p = R[R_PLANE], x0 = R[R_X], y0 = R[R_Y], w = R[R_W], h = R[R_H], type = R[R_TYPE];
  const int s0 = R[R_S0], s1 = R[R_S1], bd = D.bd, mx = (1 << bd) - 1;
  int* out = O.plane[p];
  const int opitch = O.pitch[p];
  for (int e = threadIdx.x; e < w * h; e += blockDim.x) {
    const int i = e / w, j = e % w, y = y0 + i, x = x0 + j;
    if (type == 1) {  // Wiener
      const int r0 = bd == 12 ? 5 : 3, r1 = bd == 12 ? 9 : 11;
      const int vf[7] = {R[R_C0], R[R_C1], R[R_C2], 128 - 2 * (R[R_C0] + R[R_C1] + R[R_C2]), R[R_C2], R[R_C1], R[R_C0]};
      const int hf[7] = {R[R_C3], R[R_C4], R[R_C5], 128 - 2 * (R[R_C3] + R[R_C4] + R[R_C5]), R[R_C5], R[R_C4], R[R_C3]};
      const int off = 1 << (bd + 7 - r0 - 1), limit = (1 << (bd + 1 + 7 - r0)) - 1;
      long long v = 0;
      for (int t = 0; t < 7; ++t) {
        long long s = 0;
        for (int u = 0; u < 7; ++u) s += (long long)hf[u] * lr_source(D, C, p, y + t - 3, x + u - 3, s0, s1);
        const long long it = clampll((s + (1 << (r0 - 1))) >> r0, -off, limit - off);
        v += vf[t] * it;
      }
      out[y * opitch + x] = (int)clampll((v + (1 << (r1 - 1))) >> r1, 0, mx);
    } else {  // self-guided
      const int* prm = sgr + R[R_SET] * 4;
      const long long pix = C.plane[p][y * C.pitch[p] + x];
      const long long u = pix << 4;
      long long flt[2] = {0, 0};
      for (int pass = 0; pass < 2; ++pass) {
        const int r = prm[pass], s = prm[2 + pass];
        if (!r) continue;
        long long aa = 0, bb = 0;
        int nb;
        if (pass == 0) {
          if ((i & 1) == 0) {
            for (int dy = -1; dy <= 1; dy += 2)
              for (int dx = -1; dx <= 1; ++dx) {
                int A, B;
                box_ab(D, C, p, y + dy, x + dx, s0, s1, r, s, bd, x_by_xplus1, one_by_x, &A, &B);
                const int wt = dx == 0 ? 6 : 5;
                aa += wt * A;
                bb += (long long)wt * B;
              }
            nb = 5;
          } else {
            for (int dx = -1; dx <= 1; ++dx) {
              int A, B;
              box_ab(D, C, p, y, x + dx, s0, s1, r, s, bd, x_by_xplus1, one_by_x, &A, &B);
              const int wt = dx == 0 ? 6 : 5;
              aa += wt * A;
              bb += (long long)wt * B;
            }
            nb = 4;
          }
        } else {
          for (int dy = -1; dy <= 1; ++dy)
            for (int dx = -1; dx <= 1; ++dx) {
              int A, B;
              box_ab(D, C, p, y + dy, x + dx, s0, s1, r, s, bd, x_by_xplus1, one_by_x, &A, &B);
              const int wt = (dx == 0 || dy == 0) ? 4 : 3;
              aa += wt * A;
              bb += (long long)wt * B;
            }
          nb = 5;
        }
        const int sh = 8 + nb - 4;
        flt[pass] = (aa * pix + bb + (1LL << (sh - 1))) >> sh;
      }
      const int r0 = prm[0], r1 = prm[1];
      int xq0, xq1;
      if (r0 == 0) { xq0 = 0; xq1 = 128 - R[R_XQ1]; }
      else if (r1 == 0) { xq0 = R[R_XQ0]; xq1 = 0; }
      else { xq0 = R[R_XQ0]; xq1 = 128 - R[R_XQ0] - R[R_XQ1]; }
      long long v = u << 7;
      if (r0) v += xq0 * (flt[0] - u);
      if (r1) v += xq1 * (flt[1] - u);
      out[y * opitch + x] = (int)clampll((v + (1 << 10)) >> 11, 0, mx);
    }
  }
}

Frame make_frame(void* const* planes, const int* geom, int nplanes, int bd, int edge_filter, int ssx, int ssy) {
  Frame f;
  for (int p = 0; p < 3; ++p) {
    const int q = p < nplanes ? p : 0;
    f.plane[p] = static_cast<int*>(planes[q]);
    f.pitch[p] = geom[q * 5 + 0];
    f.max_x[p] = geom[q * 5 + 1];
    f.max_y[p] = geom[q * 5 + 2];
    f.last_x[p] = geom[q * 5 + 3];
    f.last_y[p] = geom[q * 5 + 4];
  }
  f.bd = bd;
  f.edge_filter = edge_filter;
  f.ssx = ssx;
  f.ssy = ssy;
  return f;
}

}  // namespace

extern "C" {

// tables: offsets (in ints) of cospi, sinpi, fi_taps, smooth, dr_deriv, mode_angle, scans, qm, inv_shift
int dspnet_av1_recon(void* const* planes, const int* geom, int nplanes, int bd, int edge_filter, int ssx, int ssy,
                     const void* table_buf, const int* table_off, const void* txbs, const void* sb_first,
                     const void* sb_count, const void* wave_sbs, int wave_off, int wave_size, const void* coefs,
                     const void* palette, const void* maps, void* stream) {
  if (wave_size <= 0) return 0;
  const int* tb = static_cast<const int*>(table_buf);
  Tables t{tb + table_off[0], tb + table_off[1], tb + table_off[2], tb + table_off[3], tb + table_off[4],
           tb + table_off[5], tb + table_off[6], tb + table_off[7], tb + table_off[8]};
  Frame f = make_frame(planes, geom, nplanes, bd, edge_filter, ssx, ssy);
  AV1_LAUNCH(av1_recon_kernel, wave_size, 256, static_cast<cudaStream_t>(stream))(
      f, t, static_cast<const int*>(txbs), static_cast<const int*>(sb_first), static_cast<const int*>(sb_count),
      static_cast<const int*>(wave_sbs), wave_off, static_cast<const int*>(coefs),
      static_cast<const int*>(palette), static_cast<const uint8_t*>(maps));
  return static_cast<int>(cudaGetLastError());
}

int dspnet_av1_deblock(void* const* planes, const int* geom, int nplanes, int bd, const void* edges, int n_edges,
                       int dir, int sharpness, void* stream) {
  if (n_edges <= 0) return 0;
  Frame f = make_frame(planes, geom, nplanes, bd, 0, 0, 0);
  const int threads = 128;
  AV1_LAUNCH(av1_deblock_kernel, (n_edges + threads - 1) / threads, threads, static_cast<cudaStream_t>(stream))(
      f, static_cast<const int*>(edges), n_edges, dir, sharpness);
  return static_cast<int>(cudaGetLastError());
}

// params: damping, bd - 8, uv_dir[8], then y_pri, y_sec, uv_pri, uv_sec (8 each)
int dspnet_av1_cdef(void* const* src, void* const* dst, const int* geom, int nplanes, int bd, int ssx, int ssy,
                    const void* cdef_idx, int idx_pitch, const void* skip, int mi_rows, int mi_cols, int fb_rows,
                    int fb_cols, const int* params, void* stream) {
  if (fb_rows <= 0 || fb_cols <= 0) return 0;
  Frame s = make_frame(src, geom, nplanes, bd, 0, ssx, ssy);
  Frame d = make_frame(dst, geom, nplanes, bd, 0, ssx, ssy);
  CdefArgs a;
  a.damping = params[0];
  a.sh = params[1];
  for (int k = 0; k < 8; ++k) {
    a.uv_dir[k] = params[2 + k];
    a.y_pri[k] = params[10 + k];
    a.y_sec[k] = params[18 + k];
    a.uv_pri[k] = params[26 + k];
    a.uv_sec[k] = params[34 + k];
  }
  a.nplanes = nplanes;
  dim3 grid(fb_cols, fb_rows);
  AV1_LAUNCH(av1_cdef_kernel, grid, 256, static_cast<cudaStream_t>(stream))(
      s, d, static_cast<const int8_t*>(cdef_idx), idx_pitch, static_cast<const uint8_t*>(skip), mi_rows, mi_cols, a);
  return static_cast<int>(cudaGetLastError());
}

int dspnet_av1_lr(void* const* deblocked, void* const* cdefed, void* const* dst, const int* geom, int nplanes, int bd,
                  const void* rects, int n_rects, const void* sgr, const void* x_by_xplus1, const void* one_by_x,
                  void* stream) {
  if (n_rects <= 0) return 0;
  Frame D = make_frame(deblocked, geom, nplanes, bd, 0, 0, 0);
  Frame C = make_frame(cdefed, geom, nplanes, bd, 0, 0, 0);
  Frame O = make_frame(dst, geom, nplanes, bd, 0, 0, 0);
  AV1_LAUNCH(av1_lr_kernel, n_rects, 256, static_cast<cudaStream_t>(stream))(
      D, C, O, static_cast<const int*>(rects), static_cast<const int*>(sgr), static_cast<const int*>(x_by_xplus1),
      static_cast<const int*>(one_by_x));
  return static_cast<int>(cudaGetLastError());
}

const char* dspnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
