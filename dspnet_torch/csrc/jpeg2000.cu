// JPEG 2000 decode on the card: tier-1 (the EBCOT passes under the MQ
// decoder), the inverse wavelets and the inverse component transform with
// cv2's output rule, as three kernels; plain C interface.
//
// The counterpart of the JAX package's host decode, cv2.imdecode on
// OpenJPEG (dspnet_tpu/data/iterator.py:73,76; detect/detector.py:210,336):
// JPEG 2000 decoding is not a TPU kernel. The three kernels replace
// OpenJPEG's t1.c (t1_decode_kernel), dwt.c (idwt_kernel) and mct.c with
// tcd.c's DC shift and cv2's copy into its Mat (mct_store_kernel). The host
// (dspnet_torch/data/jpeg2000.py) reads the boxes, the markers and tier-2,
// the packet headers, whose cost is per packet; the wrapper
// (dspnet_torch/data/jpeg2000_cuda.py) packs every code-block's segments,
// the tables below and the tile-components' geometry into one pinned buffer
// and copies it in on the caller's stream. Each kernel is held bit for bit
// to its plain version, the plain decoder's stage (jpeg2000.tier1,
// jpeg2000.inverse_dwt, and jpeg2000.components + apply_rule), which cv2
// 5.0.0 equals on the committed forms.
//
// t1_decode_kernel: one thread per code-block, every code-block of every
// tile and component in one launch. Each thread runs the MQ decoder (or
// the raw reader of a BYPASS pass) over its segments and the significance,
// refinement and cleanup passes in stripes of four rows, with its flags in a
// scratch word per coefficient (neighbour significance and signs, and the
// coefficient's own state), and writes int32 values (twice the coefficient
// plus half a step, OpenJPEG's extra fractional bit; ROI maxshift undone)
// into the tile-component's subband at its place. What bounds it: neither
// bytes nor operations but the serial chain of MQ decisions of the largest
// code-block, at one thread a block (a warp a block is left to a later PR).
//
// idwt_kernel: one launch per decomposition level and direction over all
// tile-components (a thread per row, then a thread per column), in the
// order OpenJPEG runs them. The horizontal pass dequantises what it reads
// from tier-1 (5/3: halved as C divides an int; 9/7: times half the step
// in float32). 5/3 is integer lifting; 9/7 float32 lifting with OpenJPEG's
// constants and steps, each operation rounded on its own (__fmul_rn,
// __fadd_rn: nvcc's default --fmad=true would otherwise contract a multiply
// and an add into an FMA that neither numpy nor OpenJPEG computes). What
// bounds it: bytes, each level reading and writing its region once (through
// a scratch line); 4 bytes a sample a pass.
//
// mct_store_kernel: one thread per pixel: the inverse RCT (int) or ICT
// (float32) of the tile's first three components where the tile asks for
// it, the DC level shift, lrintf's rounding (half to even), clipping to the
// precision, then cv2's rule: the components it takes in order, shifted
// right to 8 or 16 bits and cast as C casts, or cvtColor's 15-bit gray of
// three. What bounds it: bytes, 4 bytes a component in and 1 or 2 bytes a
// channel out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// significance context by band orientation (0 LL, 1 HL, 2 LH, 3 HH) and
// the 8 neighbour significance bits (jpeg2000.ZC_LUT)
__constant__ unsigned char kZc[1024] = {
    0, 3, 3, 4, 5, 7, 7, 7, 5, 7, 7, 7, 8, 8, 8, 8, 1, 3, 3, 4, 6, 7, 7, 7, 6, 7, 7, 7, 8, 8, 8, 8,
    1, 3, 3, 4, 6, 7, 7, 7, 6, 7, 7, 7, 8, 8, 8, 8, 2, 3, 3, 4, 6, 7, 7, 7, 6, 7, 7, 7, 8, 8, 8, 8,
    1, 3, 3, 4, 6, 7, 7, 7, 6, 7, 7, 7, 8, 8, 8, 8, 2, 3, 3, 4, 6, 7, 7, 7, 6, 7, 7, 7, 8, 8, 8, 8,
    2, 3, 3, 4, 6, 7, 7, 7, 6, 7, 7, 7, 8, 8, 8, 8, 2, 3, 3, 4, 6, 7, 7, 7, 6, 7, 7, 7, 8, 8, 8, 8,
    1, 3, 3, 4, 6, 7, 7, 7, 6, 7, 7, 7, 8, 8, 8, 8, 2, 3, 3, 4, 6, 7, 7, 7, 6, 7, 7, 7, 8, 8, 8, 8,
    2, 3, 3, 4, 6, 7, 7, 7, 6, 7, 7, 7, 8, 8, 8, 8, 2, 3, 3, 4, 6, 7, 7, 7, 6, 7, 7, 7, 8, 8, 8, 8,
    2, 3, 3, 4, 6, 7, 7, 7, 6, 7, 7, 7, 8, 8, 8, 8, 2, 3, 3, 4, 6, 7, 7, 7, 6, 7, 7, 7, 8, 8, 8, 8,
    2, 3, 3, 4, 6, 7, 7, 7, 6, 7, 7, 7, 8, 8, 8, 8, 2, 3, 3, 4, 6, 7, 7, 7, 6, 7, 7, 7, 8, 8, 8, 8,
    0, 5, 5, 8, 3, 7, 7, 8, 3, 7, 7, 8, 4, 7, 7, 8, 1, 6, 6, 8, 3, 7, 7, 8, 3, 7, 7, 8, 4, 7, 7, 8,
    1, 6, 6, 8, 3, 7, 7, 8, 3, 7, 7, 8, 4, 7, 7, 8, 2, 6, 6, 8, 3, 7, 7, 8, 3, 7, 7, 8, 4, 7, 7, 8,
    1, 6, 6, 8, 3, 7, 7, 8, 3, 7, 7, 8, 4, 7, 7, 8, 2, 6, 6, 8, 3, 7, 7, 8, 3, 7, 7, 8, 4, 7, 7, 8,
    2, 6, 6, 8, 3, 7, 7, 8, 3, 7, 7, 8, 4, 7, 7, 8, 2, 6, 6, 8, 3, 7, 7, 8, 3, 7, 7, 8, 4, 7, 7, 8,
    1, 6, 6, 8, 3, 7, 7, 8, 3, 7, 7, 8, 4, 7, 7, 8, 2, 6, 6, 8, 3, 7, 7, 8, 3, 7, 7, 8, 4, 7, 7, 8,
    2, 6, 6, 8, 3, 7, 7, 8, 3, 7, 7, 8, 4, 7, 7, 8, 2, 6, 6, 8, 3, 7, 7, 8, 3, 7, 7, 8, 4, 7, 7, 8,
    2, 6, 6, 8, 3, 7, 7, 8, 3, 7, 7, 8, 4, 7, 7, 8, 2, 6, 6, 8, 3, 7, 7, 8, 3, 7, 7, 8, 4, 7, 7, 8,
    2, 6, 6, 8, 3, 7, 7, 8, 3, 7, 7, 8, 4, 7, 7, 8, 2, 6, 6, 8, 3, 7, 7, 8, 3, 7, 7, 8, 4, 7, 7, 8,
    0, 3, 3, 4, 5, 7, 7, 7, 5, 7, 7, 7, 8, 8, 8, 8, 1, 3, 3, 4, 6, 7, 7, 7, 6, 7, 7, 7, 8, 8, 8, 8,
    1, 3, 3, 4, 6, 7, 7, 7, 6, 7, 7, 7, 8, 8, 8, 8, 2, 3, 3, 4, 6, 7, 7, 7, 6, 7, 7, 7, 8, 8, 8, 8,
    1, 3, 3, 4, 6, 7, 7, 7, 6, 7, 7, 7, 8, 8, 8, 8, 2, 3, 3, 4, 6, 7, 7, 7, 6, 7, 7, 7, 8, 8, 8, 8,
    2, 3, 3, 4, 6, 7, 7, 7, 6, 7, 7, 7, 8, 8, 8, 8, 2, 3, 3, 4, 6, 7, 7, 7, 6, 7, 7, 7, 8, 8, 8, 8,
    1, 3, 3, 4, 6, 7, 7, 7, 6, 7, 7, 7, 8, 8, 8, 8, 2, 3, 3, 4, 6, 7, 7, 7, 6, 7, 7, 7, 8, 8, 8, 8,
    2, 3, 3, 4, 6, 7, 7, 7, 6, 7, 7, 7, 8, 8, 8, 8, 2, 3, 3, 4, 6, 7, 7, 7, 6, 7, 7, 7, 8, 8, 8, 8,
    2, 3, 3, 4, 6, 7, 7, 7, 6, 7, 7, 7, 8, 8, 8, 8, 2, 3, 3, 4, 6, 7, 7, 7, 6, 7, 7, 7, 8, 8, 8, 8,
    2, 3, 3, 4, 6, 7, 7, 7, 6, 7, 7, 7, 8, 8, 8, 8, 2, 3, 3, 4, 6, 7, 7, 7, 6, 7, 7, 7, 8, 8, 8, 8,
    0, 1, 1, 2, 1, 2, 2, 2, 1, 2, 2, 2, 2, 2, 2, 2, 3, 4, 4, 5, 4, 5, 5, 5, 4, 5, 5, 5, 5, 5, 5, 5,
    3, 4, 4, 5, 4, 5, 5, 5, 4, 5, 5, 5, 5, 5, 5, 5, 6, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
    3, 4, 4, 5, 4, 5, 5, 5, 4, 5, 5, 5, 5, 5, 5, 5, 6, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
    6, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8,
    3, 4, 4, 5, 4, 5, 5, 5, 4, 5, 5, 5, 5, 5, 5, 5, 6, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
    6, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8,
    6, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8,
    8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8};
// sign context (low 4 bits) and xor bit (bit 4) by the N, S, W, E
// significance and sign bits (jpeg2000.SC_LUT)
__constant__ unsigned char kSc[256] = {
    9, 10, 10, 10, 12, 13, 13, 13, 12, 13, 13, 13, 12, 13, 13, 13, 9, 26, 10, 9, 12, 11, 13, 12, 12, 11, 13, 12, 12, 11, 13, 12,
    9, 10, 26, 9, 12, 13, 11, 12, 12, 13, 11, 12, 12, 13, 11, 12, 9, 26, 26, 26, 12, 11, 11, 11, 12, 11, 11, 11, 12, 11, 11, 11,
    9, 10, 10, 10, 28, 27, 27, 27, 12, 13, 13, 13, 9, 10, 10, 10, 9, 26, 10, 9, 28, 29, 27, 28, 12, 11, 13, 12, 9, 26, 10, 9,
    9, 10, 26, 9, 28, 27, 29, 28, 12, 13, 11, 12, 9, 10, 26, 9, 9, 26, 26, 26, 28, 29, 29, 29, 12, 11, 11, 11, 9, 26, 26, 26,
    9, 10, 10, 10, 12, 13, 13, 13, 28, 27, 27, 27, 9, 10, 10, 10, 9, 26, 10, 9, 12, 11, 13, 12, 28, 29, 27, 28, 9, 26, 10, 9,
    9, 10, 26, 9, 12, 13, 11, 12, 28, 27, 29, 28, 9, 10, 26, 9, 9, 26, 26, 26, 12, 11, 11, 11, 28, 29, 29, 29, 9, 26, 26, 26,
    9, 10, 10, 10, 28, 27, 27, 27, 28, 27, 27, 27, 28, 27, 27, 27, 9, 26, 10, 9, 28, 29, 27, 28, 28, 29, 27, 28, 28, 29, 27, 28,
    9, 10, 26, 9, 28, 27, 29, 28, 28, 27, 29, 28, 28, 27, 29, 28, 9, 26, 26, 26, 28, 29, 29, 29, 28, 29, 29, 29, 28, 29, 29, 29};
// the MQ coder's 47 states: Qe, next on MPS, next on LPS, switch
__constant__ unsigned short kQe[47] = {0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201, 0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1, 0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601};
__constant__ unsigned char kNmps[47] = {1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
__constant__ unsigned char kNlps[47] = {1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
__constant__ unsigned char kSwitch[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

// code-block style bits
constexpr int kBypass = 1, kReset = 2, kVsc = 8, kSegsym = 32;
// neighbour flag bits (as jpeg2000.F_* / G_*), the state bits above them
constexpr unsigned kN = 1, kS = 2, kW = 4, kE = 8, kNW = 16, kNE = 32, kSW = 64, kSE = 128;
constexpr unsigned kGN = 256, kGS = 512, kGW = 1024, kGE = 2048;
constexpr unsigned kSig = 1u << 12, kVisit = 1u << 13, kRefined = 1u << 14;
constexpr unsigned kVscMask = ~(kS | kSW | kSE | kGS) & 0xFFFu;
constexpr int kCtxRl = 17, kCtxUni = 18;

// the block table's columns (jpeg2000_cuda.BLOCK_FIELDS)
enum { B_DATA, B_SEG, B_NSEG, B_OUT, B_STRIDE, B_W, B_H, B_ORIENT, B_NUMBPS, B_STYLE, B_ROI, B_FLAGS, B_FIELDS };
// the tile-component table (jpeg2000_cuda.TC_FIELDS) and the resolution table
enum { T_OFF, T_W, T_H, T_NL, T_REV, T_RES, T_X0, T_Y0, T_PREC, T_MCT, T_COMP, T_PAD, T_FIELDS };
enum { R_W, R_H, R_CASX, R_CASY, R_STEP, R_FIELDS = 8 };

struct Mq {
  const uint8_t* d;
  int n, bp;
  unsigned a, c;
  int ct;
  unsigned char I[19], M[19];
  // raw (bypass) reader
  unsigned rc;
  int rct;

  __device__ unsigned byte(int i) const { return i < n ? d[i] : 0xFFu; }

  __device__ void reset() {
    for (int i = 0; i < 19; ++i) { I[i] = 0; M[i] = 0; }
    I[kCtxUni] = 46; I[kCtxRl] = 3; I[0] = 4;
  }
  __device__ void bytein() {
    if (byte(bp) == 0xFF) {
      if (byte(bp + 1) > 0x8F) { c += 0xFF00u; ct = 8; }
      else { ++bp; c += byte(bp) << 9; ct = 7; }
    } else { ++bp; c += byte(bp) << 8; ct = 8; }
  }
  __device__ void init(const uint8_t* data, int len) {
    d = data; n = len; bp = 0;
    c = byte(0) << 16;
    bytein();
    c <<= 7; ct -= 7; a = 0x8000u;
  }
  __device__ void raw_init(const uint8_t* data, int len) { d = data; n = len; bp = 0; rc = 0; rct = 0; }
  __device__ int decode(int cx) {
    int i = I[cx];
    unsigned qe = kQe[i];
    int dd;
    a -= qe;
    if ((c >> 16) < qe) {
      if (a < qe) { a = qe; dd = M[cx]; I[cx] = kNmps[i]; }
      else { a = qe; dd = 1 - M[cx]; if (kSwitch[i]) M[cx] = 1 - M[cx]; I[cx] = kNlps[i]; }
    } else {
      c -= qe << 16;
      if (a & 0x8000u) return M[cx];
      if (a < qe) { dd = 1 - M[cx]; if (kSwitch[i]) M[cx] = 1 - M[cx]; I[cx] = kNlps[i]; }
      else { dd = M[cx]; I[cx] = kNmps[i]; }
    }
    do {
      if (ct == 0) bytein();
      a <<= 1; c <<= 1; --ct;
    } while (!(a & 0x8000u));
    return dd;
  }
  __device__ int raw() {
    if (rct == 0) {
      if (rc == 0xFF) {
        if (byte(bp) > 0x8F) { rc = 0xFF; rct = 8; }
        else { rc = byte(bp); ++bp; rct = 7; }
      } else { rc = byte(bp); ++bp; rct = 8; }
    }
    --rct;
    return (rc >> rct) & 1;
  }
};

__device__ __forceinline__ void make_significant(unsigned* f, int i, int W, int neg) {
  f[i] |= kSig;
  f[i - W] |= kS | (neg ? kGS : 0);
  f[i + W] |= kN | (neg ? kGN : 0);
  f[i - 1] |= kE | (neg ? kGE : 0);
  f[i + 1] |= kW | (neg ? kGW : 0);
  f[i - W - 1] |= kSE;
  f[i - W + 1] |= kSW;
  f[i + W - 1] |= kNE;
  f[i + W + 1] |= kNW;
}

__device__ __forceinline__ int decode_sign(Mq& mq, unsigned nb) {
  unsigned idx = (nb & 15u) | ((nb >> 4) & 0xF0u);
  int s = kSc[idx];
  return mq.decode(s & 15) ^ (s >> 4);
}

__global__ void t1_decode_kernel(const uint8_t* __restrict__ blob, const int* __restrict__ blocks,
                                 const int* __restrict__ segs, int nblk, int* __restrict__ coef,
                                 unsigned* __restrict__ flags) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nblk) return;
  const int* B = blocks + (size_t)b * B_FIELDS;
  const int w = B[B_W], h = B[B_H], W = w + 2, stride = B[B_STRIDE];
  const int orient = B[B_ORIENT], numbps = B[B_NUMBPS], style = B[B_STYLE], roi = B[B_ROI];
  const bool vsc = style & kVsc;
  const unsigned char* zc = kZc + orient * 256;
  unsigned* f = flags + B[B_FLAGS];
  int* out = coef + B[B_OUT];
  const uint8_t* data = blob + B[B_DATA];
  Mq mq;
  mq.reset();
  int bpp1 = roi + numbps;
  int passtype = 2;
  for (int s = 0; s < B[B_NSEG]; ++s) {
    const int len = segs[2 * (B[B_SEG] + s)], npass = segs[2 * (B[B_SEG] + s) + 1];
    const bool is_raw = (style & kBypass) && passtype < 2 && bpp1 <= numbps - 4;
    if (is_raw) mq.raw_init(data, len); else mq.init(data, len);
    data += len;
    for (int p = 0; p < npass && bpp1 >= 1; ++p) {
      const int oph = (1 << bpp1) | (1 << (bpp1 - 1));
      if (passtype == 0) {  // significance propagation
        for (int k = 0; k < h; k += 4) {
          for (int x = 0; x < w; ++x) {
            for (int j = k; j < k + 4 && j < h; ++j) {
              const int i = (j + 1) * W + x + 1;
              const unsigned m = (vsc && j - k == 3) ? kVscMask : 0xFFFu;
              if (f[i] & kSig) continue;
              const unsigned nb = f[i] & m;
              if (!(nb & 0xFF)) continue;
              const int o = j * stride + x;
              if (is_raw) {
                if (mq.raw()) {
                  int neg = mq.raw();
                  out[o] = neg ? -oph : oph;
                  make_significant(f, i, W, neg);
                }
              } else if (mq.decode(zc[nb & 0xFF])) {
                int neg = decode_sign(mq, nb);
                out[o] = neg ? -oph : oph;
                make_significant(f, i, W, neg);
              }
              f[i] |= kVisit;
            }
          }
        }
      } else if (passtype == 1) {  // magnitude refinement
        const int half = 1 << (bpp1 - 1);
        for (int k = 0; k < h; k += 4) {
          for (int x = 0; x < w; ++x) {
            for (int j = k; j < k + 4 && j < h; ++j) {
              const int i = (j + 1) * W + x + 1;
              const unsigned st = f[i];
              if ((st & (kSig | kVisit)) != kSig) continue;
              const unsigned m = (vsc && j - k == 3) ? kVscMask : 0xFFFu;
              int v;
              if (is_raw) v = mq.raw();
              else v = mq.decode((st & kRefined) ? 16 : ((st & m & 0xFF) ? 15 : 14));
              const int o = j * stride + x;
              const int d = out[o];
              out[o] = d + ((v ^ (d < 0)) ? half : -half);
              f[i] = st | kRefined;
            }
          }
        }
      } else {  // cleanup
        for (int k = 0; k < h; k += 4) {
          const bool full = k + 4 <= h;
          for (int x = 0; x < w; ++x) {
            int start = k;
            if (full) {
              bool run = true;
              for (int j = 0; j < 4; ++j) {
                const int i = (k + j + 1) * W + x + 1;
                const unsigned m = (vsc && j == 3) ? kVscMask : 0xFFFu;
                if ((f[i] & (kSig | kVisit)) || (f[i] & m & 0xFF)) { run = false; break; }
              }
              if (run) {
                if (!mq.decode(kCtxRl)) continue;
                int r = mq.decode(kCtxUni) << 1;
                r |= mq.decode(kCtxUni);
                const int j = k + r;
                const int i = (j + 1) * W + x + 1;
                const unsigned m = (vsc && r == 3) ? kVscMask : 0xFFFu;
                int neg = decode_sign(mq, f[i] & m);
                out[j * stride + x] = neg ? -oph : oph;
                make_significant(f, i, W, neg);
                start = j + 1;
              }
            }
            for (int j = start; j < k + 4 && j < h; ++j) {
              const int i = (j + 1) * W + x + 1;
              if (f[i] & (kSig | kVisit)) continue;
              const unsigned m = (vsc && j - k == 3) ? kVscMask : 0xFFFu;
              const unsigned nb = f[i] & m;
              if (mq.decode(zc[nb & 0xFF])) {
                int neg = decode_sign(mq, nb);
                out[j * stride + x] = neg ? -oph : oph;
                make_significant(f, i, W, neg);
              }
            }
          }
        }
        for (int j = 0; j < h; ++j)
          for (int x = 0; x < w; ++x) f[(j + 1) * W + x + 1] &= ~kVisit;
        if (style & kSegsym)
          for (int q = 0; q < 4; ++q) mq.decode(kCtxUni);
      }
      if ((style & kReset) && !is_raw) mq.reset();
      if (++passtype == 3) { passtype = 0; --bpp1; }
    }
  }
  if (roi) {
    for (int j = 0; j < h; ++j)
      for (int x = 0; x < w; ++x) {
        const int v = out[j * stride + x];
        const int mag = v < 0 ? -v : v;
        if (mag >= (1 << roi)) out[j * stride + x] = v < 0 ? -(mag >> roi) : (mag >> roi);
      }
  }
}

// ------------------------------------------------------------------ wavelet

__device__ __forceinline__ int half_trunc(int v) { return v < 0 ? -((-v) >> 1) : v >> 1; }

// OpenJPEG's opj_v8dwt_decode_step2 over one line X (elements `step` apart)
__device__ void step2(float* X, int step, int l, int w, int end, int m, float c) {
  const int imax = min(end, m);
  for (int i = 0; i < imax; ++i) {
    int lp = w - 2 + 2 * i;
    if (lp < 0) lp = l;
    float* t = X + (w - 1 + 2 * i) * step;
    *t = __fadd_rn(*t, __fmul_rn(__fadd_rn(X[lp * step], X[(w + 2 * i) * step]), c));
  }
  if (m < end) {
    const int fl = m == 0 ? l : w + 2 * (m - 1);
    float* t = X + (w - 1 + 2 * m) * step;
    *t = __fadd_rn(*t, __fmul_rn(X[fl * step], __fadd_rn(c, c)));
  }
}

__device__ void lift97(float* X, int step, int n, int sn, int cas) {
  const int dn = n - sn;
  int a, b;
  if (cas == 0) {
    if (!(dn > 0 || sn > 1)) return;
    a = 0; b = 1;
  } else {
    if (!(sn > 0 || dn > 1)) return;
    a = 1; b = 0;
  }
  const float K = 1.230174105f, TWO_INV_K = 1.625732422f;
  for (int i = 0; i < sn; ++i) X[(a + 2 * i) * step] = __fmul_rn(X[(a + 2 * i) * step], K);
  for (int i = 0; i < dn; ++i) X[(b + 2 * i) * step] = __fmul_rn(X[(b + 2 * i) * step], TWO_INV_K);
  step2(X, step, b, a + 1, sn, min(sn, dn - a), -0.443506852f);
  step2(X, step, a, b + 1, dn, min(dn, sn - b), -0.882911075f);
  step2(X, step, b, a + 1, sn, min(sn, dn - a), 0.052980118f);
  step2(X, step, a, b + 1, dn, min(dn, sn - b), 1.586134342f);
}

__device__ void lift53(int* X, int step, int n, int sn, int cas) {
  if (n == 1) {
    if (cas) X[0] = half_trunc(X[0]);
    return;
  }
  const int dn = n - sn;
  if (cas == 0) {
    for (int i = 0; i < sn; ++i) {
      const int l = X[(2 * max(i - 1, 0) + 1) * step], r = X[(2 * min(i, dn - 1) + 1) * step];
      X[2 * i * step] -= (l + r + 2) >> 2;
    }
    for (int i = 0; i < dn; ++i)
      X[(2 * i + 1) * step] += (X[2 * i * step] + X[2 * min(i + 1, sn - 1) * step]) >> 1;
  } else {
    for (int i = 0; i < sn; ++i)
      X[(2 * i + 1) * step] -= (X[2 * i * step] + X[2 * min(i + 1, dn - 1) * step] + 2) >> 2;
    for (int i = 0; i < dn; ++i)
      X[2 * i * step] += (X[(2 * max(i - 1, 0) + 1) * step] + X[(2 * min(i, sn - 1) + 1) * step]) >> 1;
  }
}

// direction 0: rows of level `level` (dequantising what tier-1 left raw);
// 1: columns of that level; 2: dequantise a tile-component that has no
// decomposition (level 0), row by row.
__global__ void idwt_kernel(int* __restrict__ buf, int* __restrict__ tmp, const int* __restrict__ tcs,
                            const int* __restrict__ res, int level, int direction) {
  const int* T = tcs + (size_t)blockIdx.y * T_FIELDS;
  const int nl = T[T_NL];
  if (direction == 2 ? nl != 0 : nl < level) return;
  const int off = T[T_OFF], w = T[T_W];
  const bool rev = T[T_REV];
  const int* R0 = res + (size_t)T[T_RES] * R_FIELDS;
  const int* R = R0 + level * R_FIELDS;
  const int rw = R[R_W], rh = R[R_H];
  const int line = blockIdx.x * blockDim.x + threadIdx.x;
  if (direction == 2) {
    if (line >= rh) return;
    int* row = buf + off + (size_t)line * w;
    const float hs = __int_as_float(R0[R_STEP]);
    for (int x = 0; x < rw; ++x)
      row[x] = rev ? half_trunc(row[x]) : __float_as_int(__fmul_rn(__int2float_rn(row[x]), hs));
    return;
  }
  const int* P = R - R_FIELDS;
  const int snh = P[R_W], snv = P[R_H];
  if (direction == 0) {
    if (line >= rh || rw == 0) return;
    const int y = line;
    int* row = buf + off + (size_t)y * w;
    int* X = tmp + off + (size_t)y * w;
    const int cas = R[R_CASX];
    for (int x = 0; x < rw; ++x) {
      int v = row[x];
      const bool raw = !(level > 1 && y < snv && x < snh);
      const int pos = x < snh ? 2 * x + cas : 2 * (x - snh) + 1 - cas;
      if (raw) {
        const int orient = (x >= snh) | ((y >= snv) << 1);
        if (rev) v = half_trunc(v);
        else v = __float_as_int(__fmul_rn(__int2float_rn(v), __int_as_float((orient ? R : R0)[R_STEP + orient])));
      }
      X[pos] = v;
    }
    if (rev) lift53(X, 1, rw, snh, cas);
    else lift97(reinterpret_cast<float*>(X), 1, rw, snh, cas);
    for (int x = 0; x < rw; ++x) row[x] = X[x];
  } else {
    if (line >= rw || rh == 0) return;
    const int x = line;
    int* col = buf + off + x;
    int* X = tmp + off + x;
    const int cas = R[R_CASY];
    for (int y = 0; y < rh; ++y) {
      const int pos = y < snv ? 2 * y + cas : 2 * (y - snv) + 1 - cas;
      X[(size_t)pos * w] = col[(size_t)y * w];
    }
    if (rev) lift53(X, w, rh, snv, cas);
    else lift97(reinterpret_cast<float*>(X), w, rh, snv, cas);
    for (int y = 0; y < rh; ++y) col[(size_t)y * w] = X[(size_t)y * w];
  }
}

// ---------------------------------------------------------------- mct, store

struct StoreArgs {
  int height, width, tw, th, ntx, ncomp, out_ch, to_gray, shift, out16;
  int chan[4];
};

__global__ void mct_store_kernel(const int* __restrict__ buf, const int* __restrict__ tcs, StoreArgs s,
                                 void* __restrict__ out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x, y = blockIdx.y;
  if (x >= s.width || y >= s.height) return;
  const int tile = (y / s.th) * s.ntx + x / s.tw;
  const int* T0 = tcs + (size_t)tile * s.ncomp * T_FIELDS;
  int v[4];
  float fv[3];
  const bool mct = T0[T_MCT] && s.ncomp >= 3;
  for (int c = 0; c < s.ncomp && c < 4; ++c) {
    const int* T = T0 + c * T_FIELDS;
    v[c] = buf[T[T_OFF] + (size_t)(y - T[T_Y0]) * T[T_W] + (x - T[T_X0])];
  }
  bool is_float[4];
  for (int c = 0; c < s.ncomp && c < 4; ++c) is_float[c] = !T0[c * T_FIELDS + T_REV];
  if (mct) {
    if (!is_float[0]) {
      const int yy = v[0], u = v[1], vv = v[2];
      const int g = yy - ((u + vv) >> 2);
      v[0] = vv + g; v[1] = g; v[2] = u + g;
      is_float[1] = is_float[2] = false;
    } else {
      for (int c = 0; c < 3; ++c) fv[c] = is_float[c] ? __int_as_float(v[c]) : __int2float_rn(v[c]);
      const float r = __fadd_rn(fv[0], __fmul_rn(fv[2], 1.402f));
      const float g = __fsub_rn(__fsub_rn(fv[0], __fmul_rn(fv[1], 0.34413f)), __fmul_rn(fv[2], 0.71414f));
      const float b = __fadd_rn(fv[0], __fmul_rn(fv[1], 1.772f));
      v[0] = __float_as_int(r); v[1] = __float_as_int(g); v[2] = __float_as_int(b);
      is_float[0] = is_float[1] = is_float[2] = true;
    }
  }
  int samp[4];
  for (int c = 0; c < s.ncomp && c < 4; ++c) {
    const int prec = T0[c * T_FIELDS + T_PREC];
    int q = is_float[c] ? __float2int_rn(__int_as_float(v[c])) : v[c];
    q += 1 << (prec - 1);
    samp[c] = min(max(q, 0), (1 << prec) - 1);
  }
  const size_t o = ((size_t)y * s.width + x) * (s.to_gray ? 1 : s.out_ch);
  if (s.to_gray) {  // R, G, B as the output type, then cvtColor's 15-bit gray
    unsigned r = samp[s.chan[0]] >> s.shift, g = samp[s.chan[1]] >> s.shift, b = samp[s.chan[2]] >> s.shift;
    r &= 0xFFu; g &= 0xFFu; b &= 0xFFu;
    static_cast<uint8_t*>(out)[o] = (uint8_t)((3735u * b + 19235u * g + 9798u * r + 16384u) >> 15);
    return;
  }
  for (int k = 0; k < s.out_ch; ++k) {
    const unsigned q = (unsigned)samp[s.chan[k]] >> s.shift;
    if (s.out16) static_cast<uint16_t*>(out)[o + k] = (uint16_t)q;
    else static_cast<uint8_t*>(out)[o + k] = (uint8_t)q;
  }
}

}  // namespace

extern "C" {

int dspnet_j2k_t1(const void* blob, const void* blocks, const void* segs, int nblk, void* coef, void* flags,
                  void* stream) {
  if (nblk <= 0) return 0;
  const int threads = 64;
  t1_decode_kernel<<<(nblk + threads - 1) / threads, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blob), static_cast<const int*>(blocks), static_cast<const int*>(segs), nblk,
      static_cast<int*>(coef), static_cast<unsigned*>(flags));
  return static_cast<int>(cudaGetLastError());
}

int dspnet_j2k_idwt(void* buf, void* tmp, const void* tcs, const void* res, int ntc, int level, int direction,
                    int lines, void* stream) {
  if (ntc <= 0 || lines <= 0) return 0;
  const int threads = 128;
  dim3 grid((lines + threads - 1) / threads, ntc);
  idwt_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(buf), static_cast<int*>(tmp), static_cast<const int*>(tcs), static_cast<const int*>(res),
      level, direction);
  return static_cast<int>(cudaGetLastError());
}

int dspnet_j2k_mct_store(const void* buf, const void* tcs, int height, int width, int tw, int th, int ntx,
                         int ncomp, int out_ch, int to_gray, int shift, int out16, const int* chan, void* out,
                         void* stream) {
  StoreArgs s{height, width, tw, th, ntx, ncomp, out_ch, to_gray, shift, out16, {0, 0, 0, 0}};
  for (int k = 0; k < 4; ++k) s.chan[k] = chan[k];
  const int threads = 256;
  dim3 grid((width + threads - 1) / threads, height);
  mct_store_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(buf), static_cast<const int*>(tcs), s, out);
  return static_cast<int>(cudaGetLastError());
}

const char* dspnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
