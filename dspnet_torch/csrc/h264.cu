// H.264 decoding on the card: the slice-data parse, the reconstruction and
// the deblocking filter of 8-bit 4:2:0 (and 4:0:0) progressive frames, as
// six kernels; plain C interface.
//
// The counterpart of the JAX package's cv2.VideoCapture (FFmpeg's h264
// decoder) behind dspnet_tpu/detect/detector.py:289: H.264 decoding is not a
// TPU kernel. The host (dspnet_torch/data/h264_nal.py, h264_dpb.py) reads the
// NAL units, parameter sets and slice headers and plans the decoded picture
// buffer; the wrapper (dspnet_torch/data/h264_cuda.py) copies a batch's
// slice data and tables in once on the caller's stream. Each kernel is held
// bit for bit to its plain version (h264_parse.parse_slice,
// h264_recon.recon_picture, h264_filters.deblock_picture), which cv2 5.0.0
// equals on the committed forms.
//
// h264_parse_kernel: a warp per slice (a block each), every slice of a
// batch in one launch. Parsing needs no pixels and no motion vectors, so
// slices parse side by side. What bounds it: neither bytes nor operations
// but the serial chain of bins (CABAC) or codes (CAVLC) of one slice, so
// every link of the chain is a register or shared-memory step: lane 0 reads
// the RBSP through a 64-bit register window refilled a word at a time (the
// next word loaded ahead), renormalises CABAC in one shift, reads each
// context's state as its transition record, decodes CAVLC codes by
// two-level lookup tables, and keeps the neighbour state (the left and
// upper macroblocks' table rows and scratch) in a shared ring of the
// current and previous rows; each macroblock's row, scratch and levels are
// built in shared memory and stored by the warp in one coalesced pass while
// lane 0 parses the next. The kernel as it was before (one thread, every
// step a device-memory access) is kept in baselines/h264_parse_per_thread.cu
// as a yardstick.
//
// The reconstruction, one picture a call of its three kernels in order.
// Only what reads a neighbour's result of the same picture keeps the
// standard's order, macroblock (x, y) after (x + 1, y - 1): rows of
// macroblocks are handed to blocks in order, and a row waits on the
// progress the row above publishes (a persistent grid no larger than what
// is co-resident; sync words zeroed before each launch).
//   h264_mv_kernel: the motion vectors and references (median and
//     directional prediction, P_Skip, B direct spatial and temporal from the
//     co-located picture's motion field), a warp a row; integer work on
//     the motion field alone.
//   h264_inter_kernel: every macroblock at once, a block each: the
//     residual (dequantisation, 4x4 / 8x8 / DC transforms, threads over
//     transform rows, then a thread a sample) and, for inter macroblocks,
//     the prediction from reference windows staged in shared memory (6-tap
//     luma, bilinear chroma, weighted prediction), added and clipped.
//   h264_intra_kernel: the intra macroblocks in the standard's order, after
//     every inter sample is in place; threads over the samples of each
//     4x4 / 8x8 / 16x16 prediction, the macroblock's neighbourhood in shared
//     memory; rows without intra macroblocks pass straight through.
// What bounds it: the chain of rows, each waiting on the one above, in the
// motion vector and intra stages; the inter stage's reference reads.
//
// The deblocking filter, in place, two kernels:
//   h264_bs_kernel: every edge segment's boundary strength at once, a
//     thread a segment (the table, the motion field and reference ids);
//   h264_filter_kernel: the standard's order across macroblocks as above
//     (a block a row); within a macroblock the 4 vertical edges and then
//     the 4 horizontal ones, the threads over an edge's 16 luma and 16
//     chroma lines; a macroblock whose bS are all 0 is passed over.
//
// The kernels as they were before (one block on one SM, a thread a
// macroblock) are kept in baselines/h264_wave_per_thread.cu as a yardstick.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef H264_LAUNCH
#define H264_LAUNCH(kernel, grid, block, stream) kernel<<<(grid), (block), 0, (stream)>>>
#endif
#ifndef H264_LAUNCH_SHARED
#define H264_LAUNCH_SHARED(kernel, grid, block, shared, stream) kernel<<<(grid), (block), (shared), (stream)>>>
#endif
// a kernel's dynamic shared memory (sized at launch)
#ifndef DYNAMIC_SHARED
#define DYNAMIC_SHARED(name) extern __shared__ __align__(16) uint8_t name[]
#endif
// the launch geometry's caps: threads a block and blocks a grid (every
// kernel strides by blockDim and gridDim; a host emulation builds with small
// ones, and its tests force a grid smaller than a picture's rows and one larger)
#ifndef H264_MAX_THREADS
#define H264_MAX_THREADS 1024
#endif
#ifndef H264_MAX_BLOCKS
#define H264_MAX_BLOCKS (1 << 30)
#endif
// threads a block of the parse kernel: a warp (1 to 32; its loops over
// lanes stride by blockDim, and lane 0 alone parses)
#ifndef H264_PARSE_THREADS
#define H264_PARSE_THREADS (H264_MAX_THREADS < 32 ? H264_MAX_THREADS : 32)
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

// The slice's RBSP through a 64-bit window: refilled a 32-bit word at a time
// from device memory, the next word loaded one refill ahead, so that a
// refill never waits on a load. Bits at and past the slice's last byte read
// as 0; pos counts bits from the slice's start as the standard's reader
// would, and err takes E_OVERRUN where a read_bits reads past the end.
struct Bits {
  const uint32_t* words;  // the slice's bytes as aligned words (from the word holding its first byte)
  uint64_t cache;         // the bits from pos on, left-aligned
  int next;               // the bit (of words) after the cache's last, a multiple of 32
  int lim;                // the bit past the slice's last byte
  int base;               // the bit of the slice's first byte
  uint32_t ahead;         // the word at next
  int avail;              // valid bits in cache: 33 to 64 between reads
  int pos, end, err;
  int steps;              // VLC and Exp-Golomb codes read (the CAVLC chain's steps)

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
    pos = bit;
    end = nbytes * 8;
    err = 0;
    steps = 0;
  }
  // the next n bits, 1 <= n <= 32, not consumed
  __device__ __forceinline__ uint32_t peek(int n) const { return (uint32_t)(cache >> (64 - n)); }
  // consume n bits, 0 <= n <= 32
  __device__ __forceinline__ void skip(int n) {
    cache <<= n;
    avail -= n;
    pos += n;
    if (__builtin_expect(avail <= 32, 0)) refill();
  }
  __device__ __forceinline__ uint32_t take(int n) {
    const uint32_t v = n ? peek(n) : 0u;
    skip(n);
    return v;
  }
  __device__ __forceinline__ int bit() {
    const int b = (int)take(1);
    if (pos > end) err = E_OVERRUN;
    return b;
  }
  __device__ __forceinline__ int u(int n) {
    const int v = (int)take(n);
    if (n && pos > end) err = E_OVERRUN;
    return v;
  }
  __device__ int ue() {
    steps++;
    const int z = __clzll(cache);
    if (!err && z <= 31 && pos + 2 * z + 1 <= end) {  // the prefix and suffix inside the slice
      skip(z + 1);
      return (int)((1u << z) - 1 + take(z));
    }
    int zeros = 0;  // the reader one bit at a time, errors as they fall
    while (bit() == 0) {
      if (++zeros > 31 || err) {
        err = err ? err : E_VLC;
        return 0;
      }
    }
    return (int)((1u << zeros) - 1 + (zeros ? (unsigned)u(zeros) : 0u));
  }
  __device__ __forceinline__ int se() {
    const int k = ue();
    return (k & 1) ? (k + 1) >> 1 : -(k >> 1);
  }
};

// The CABAC decoding engine; its tables in shared memory: ctab[s] for each
// state s = pStateIdx << 1 | valMPS, (rangeTabLPS of its four quarters, a
// byte each; the next state after an MPS | after an LPS << 8 | valMPS <<
// 16), and each context's state held as its ctab record, so that a bin
// waits on one shared-memory load (the next record is stored after it). The
// offset is the top 9 bits of a 64-bit register w whose lower bits are the
// slice's next bits, wbits of them (17 to 55), refilled a word at a time by
// the reader's loader; renormalisation is one shift of w and range by the
// leading zeros of range. The bits consumed (the reader's pos) and E_OVERRUN
// (16 bits past the end, where the bits read as 0) are settled at the
// macroblock's end, before I_PCM and at the slice's end: nothing reads them
// between.
struct Engine {
  Bits bs;  // the reader: its loader feeds w while the engine runs
  const uint2* ctab;
  uint2* state;  // the contexts' records
  uint64_t w;
  int wbits, range;
  int steps;  // bins decoded (the CABAC chain's steps)

  __device__ __forceinline__ void fill() {
    if (__builtin_expect(wbits <= 23, 0)) {
      w |= (uint64_t)bs.ahead << (23 - wbits);
      wbits += 32;
      bs.next += 32;
      bs.ahead = bs.word(bs.next);
    }
  }
  // from the reader's position: the offset's 9 bits and the bits after them
  __device__ void start() {
    range = 510;
    w = bs.cache;
    wbits = bs.avail - 9;
  }
  __device__ __forceinline__ void settle() {
    bs.pos = bs.next - bs.base - wbits;
    if (bs.pos > bs.end + 16) bs.err = E_OVERRUN;
  }
  // back to the reader at the engine's position (I_PCM)
  __device__ void to_reader() {
    settle();
    bs.cache = w << 9;
    bs.avail = wbits;
    while (bs.avail <= 32) bs.refill();
  }
  __device__ __forceinline__ int chain_steps() const { return steps + bs.steps; }
  __device__ __forceinline__ void renorm() {
    const int n = __clz(range) - 23;
    range <<= n;
    w <<= n;
    wbits -= n;
    fill();
  }
  // a bin of context ctx whose record t the caller loaded (ahead, where it
  // knew the context before the previous bin's value); its next record is
  // stored and left in next, for a caller that decodes ctx again
  __device__ __forceinline__ int decision(int ctx, uint2 t, uint2& next) {
    steps++;
    const int lps = (t.x >> (((range >> 6) & 3) << 3)) & 0xFF;
    const int r = range - lps;
    // the offset against r << 55: on the high word alone (the low word of r << 55 is 0)
    const uint32_t rs = (uint32_t)r << 23;
    const bool lps_bin = (uint32_t)(w >> 32) >= rs;  // selects, no branch
    w -= (uint64_t)(lps_bin ? rs : 0u) << 32;
    range = lps_bin ? lps : r;
    next = ctab[(t.y >> (lps_bin ? 8 : 0)) & 0xFF];
    state[ctx] = next;
    renorm();
    return (int)((t.y >> 16) & 1) ^ (int)lps_bin;
  }
  __device__ __forceinline__ int decision(int ctx) {
    uint2 next;
    return decision(ctx, state[ctx], next);
  }
  __device__ __forceinline__ int bypass() {
    steps++;
    const uint32_t top = (uint32_t)(w >> 63), rs = (uint32_t)range << 23;
    w <<= 1;
    wbits -= 1;
    int b = 0;
    if (top || (uint32_t)(w >> 32) >= rs) {  // the offset doubled plus a bit, which may carry past the register
      w -= (uint64_t)rs << 32;
      b = 1;
    }
    fill();
    return b;
  }
  __device__ __forceinline__ int terminate() {
    steps++;
    range -= 2;
    if ((uint32_t)(w >> 32) >= (uint32_t)range << 23) return 1;
    renorm();
    return 0;
  }
};

// one macroblock's slot of the shared ring of the current and previous rows:
// its table row (N_FIELDS words, h264_parse.MB_FIELDS) and its scratch bytes
constexpr int SLOT_BYTES = 352;  // N_FIELDS * 4 + N_SCRATCH, rounded up to 16
constexpr int SCRATCH_AT = N_FIELDS * 4;
// the parse's tables copied to shared memory: the int32 tables from O_LPS
// to O_ALPHA (their offsets less O_LPS), and the CAVLC lookup tables
constexpr int N_TS = O_ALPHA - O_LPS;
// the CAVLC lookup tables (h264_cuda._vlc_tables): words [0] the region's
// size, [1 + k] where code table k starts; an entry is symbol << 8 | length
// (0: no code), or -(start << 4 | bits) for a second-level table indexed by
// the bits after the first 8
enum { V_TOKEN = 0, V_CDC_TOKEN = 4, V_TZ = 5, V_CDC_TZ = 20, V_RUN = 23, N_VLC_TABLES = 30 };

// the parse kernel's dynamic shared memory, in bytes from its start
struct ParseLayout {
  int ctab, state, ts, vlc, levels, info, ring, bytes;
  __host__ __device__ ParseLayout(int nvlc, int mbw_max) {
    ctab = 0;                          // 128 uint2
    state = ctab + 128 * 8;            // 1024 contexts' records (uint2)
    ts = state + 1024 * 8;             // N_TS int32
    vlc = ts + 4 * N_TS;               // nvlc int32
    levels = (vlc + 4 * nvlc + 15) & ~15;  // 2 x N_LEVELS int16, a macroblock's levels, double-buffered
    info = levels + 4 * N_LEVELS;      // 2 x 4 int32, what each step hands the warp
    ring = (info + 32 + 15) & ~15;     // (mbw_max + 1) slots
    bytes = ring + (mbw_max + 1) * SLOT_BYTES;
  }
};

struct Parser {
  Engine e;  // e.bs reads CAVLC too
  const int* Ts;
  const int* vlcs;
  uint8_t* ring;  // the slots
  int16_t* lv;    // the current macroblock's levels (shared, zeroed)
  int slice_index, first, st, cabac, cip, t8mode, direct8, chroma, mbw, mbh, nmb;
  int nref[2];
  int mb, mbA, mbB, qp, prev_dqp, cur, nslot, stop;
  int err;
  // the step machine: the macroblock a step enters, skips left of a run
  int m, skips, done;

  __device__ __forceinline__ int T(int off) const { return Ts[off - O_LPS]; }
  __device__ __forceinline__ int slot(int m_) const {
    const int s = cur + (m_ - mb);
    return s < 0 ? s + nslot : s;
  }
  __device__ __forceinline__ int32_t* row(int m_) { return (int32_t*)(ring + slot(m_) * SLOT_BYTES); }
  __device__ __forceinline__ uint8_t* scr(int m_) { return ring + slot(m_) * SLOT_BYTES + SCRATCH_AT; }
  __device__ __forceinline__ void fail(int code) {
    if (!err) err = code;
  }
  __device__ __forceinline__ bool more_rbsp_data() const { return e.bs.pos < stop; }
  __device__ int avail(int m_) { return m_ >= first && m_ < mb; }
  __device__ int nb(int which) {
    int x = mb % mbw, y = mb / mbw, n = -1;
    if (which == 0) n = x > 0 ? mb - 1 : -1;
    else n = y > 0 ? mb - mbw : -1;
    return (n >= 0 && avail(n)) ? n : -1;
  }
  __device__ int type(int m_) { return row(m_)[F_TYPE]; }
  __device__ int is_intra(int m_) { return type(m_) <= T_PCM; }
  __device__ int is_skip(int m_) { int t = type(m_); return t == T_PSKIP || t == T_BSKIP; }
  __device__ void left4(int b, int& m_, int& bb) {
    int x = blk_x(b), y = blk_y(b);
    if (x > 0) { m_ = mb; bb = blk_at(y, x - 1); } else { m_ = mbA; bb = blk_at(y, 3); }
  }
  __device__ void top4(int b, int& m_, int& bb) {
    int x = blk_x(b), y = blk_y(b);
    if (y > 0) { m_ = mb; bb = blk_at(y - 1, x); } else { m_ = mbB; bb = blk_at(3, x); }
  }
  __device__ int refidx(int m_, int lx, int k) {
    int r = (row(m_)[F_REF0 + lx] >> (8 * k)) & 0xFF;
    return r == 0xFF ? -1 : r;
  }
  __device__ void set_ref(int lx, int k, int r) {
    int32_t* rw = row(mb);
    uint32_t v = (uint32_t)rw[F_REF0 + lx];
    v = (v & ~(0xFFu << (8 * k))) | ((uint32_t)(r & 0xFF) << (8 * k));
    rw[F_REF0 + lx] = (int32_t)v;
  }
  __device__ int mvd_of(int m_, int lx, int b, int c) { return row(m_)[F_MVD + (lx * 16 + b) * 2 + c]; }
  __device__ int imode_of(int m_, int b) {
    int32_t w = row(m_)[b < 8 ? F_IM0 : F_IM1];
    return (w >> (4 * (b & 7))) & 15;
  }
  __device__ void set_imode(int b, int mode) {
    int32_t* rw = row(mb);
    int f = b < 8 ? F_IM0 : F_IM1;
    uint32_t v = (uint32_t)rw[f];
    v = (v & ~(15u << (4 * (b & 7)))) | ((uint32_t)mode << (4 * (b & 7)));
    rw[f] = (int32_t)v;
  }

  // ---- setting up a macroblock: its slot cleared (the levels were cleared
  // when the warp stored the previous ones)
  __device__ void enter(int m_, int16_t* levels) {
    cur = m_ == first ? 0 : (cur + 1 == nslot ? 0 : cur + 1);
    mb = m_;
    lv = levels;
    mbA = nb(0);
    mbB = nb(1);
    uint4* w = (uint4*)(ring + cur * SLOT_BYTES);
    for (int i = 0; i < SLOT_BYTES / 16; i++) w[i] = make_uint4(0, 0, 0, 0);
    int32_t* rw = row(m_);
    rw[F_SLICE] = slice_index;
    rw[F_REF0] = rw[F_REF1] = -1;
    scr(m_)[SC_CODED] = 1;
  }

  // the nonzero 4x4 blocks from the coefficient counts: a block's levels
  // are nonzero where its count is (an 8x8 block's where any of its four)
  __device__ void finish() {
    int32_t* rw = row(mb);
    rw[F_QP] = qp;
    int t = rw[F_TYPE], nz = 0;
    if (t != T_PCM) {
      const uint8_t* s = scr(mb) + SC_COUNT;
      for (int b = 0; b < 16; b++) {
        int any = rw[F_T8] ? (s[b & ~3] | s[(b & ~3) + 1] | s[(b & ~3) + 2] | s[(b & ~3) + 3]) : s[b];
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
    return e.decision((st == ST_P ? 11 : 24) + inc);
  }
  __device__ int intra_type(int base, int in_i) {
    int luma, c0, c1, p1, p0;
    if (in_i) {
      int inc = (mbA >= 0 && type(mbA) != T_I4 && type(mbA) != T_I8) + (mbB >= 0 && type(mbB) != T_I4 && type(mbB) != T_I8);
      if (!e.decision(base + inc)) return 0;
      int s = base + 3;
      luma = s; c0 = s + 1; c1 = s + 2; p1 = s + 3; p0 = s + 4;
    } else {
      if (!e.decision(base)) return 0;
      int s = base + 1;
      luma = s; c0 = s + 1; c1 = s + 1; p1 = s + 2; p0 = s + 2;
    }
    if (e.terminate()) return 25;
    int t = 1 + 12 * e.decision(luma);
    if (e.decision(c0)) t += 4 + 4 * e.decision(c1);
    t += 2 * e.decision(p1);
    t += e.decision(p0);
    return t;
  }
  __device__ __forceinline__ int cabac_mb_type() {
    if (st == ST_I) return intra_type(3, 1);
    if (st == ST_P) {
      if (e.decision(14) == 0) {
        if (e.decision(15) == 0) return 3 * e.decision(16);
        return 2 - e.decision(17);
      }
      return 5 + intra_type(17, 0);
    }
    int inc = (mbA >= 0 && type(mbA) != T_BSKIP && type(mbA) != T_BDIRECT) +
              (mbB >= 0 && type(mbB) != T_BSKIP && type(mbB) != T_BDIRECT);
    if (!e.decision(27 + inc)) return 0;
    if (!e.decision(30)) return 1 + e.decision(32);
    int bits = e.decision(31) << 3;
    bits |= e.decision(32) << 2;
    bits |= e.decision(32) << 1;
    bits |= e.decision(32);
    if (bits < 8) return bits + 3;
    if (bits == 13) return 23 + intra_type(32, 0);
    if (bits == 14) return 11;
    if (bits == 15) return 22;
    bits = (bits << 1) | e.decision(32);
    return bits - 4;
  }
  __device__ int cabac_sub_type() {
    if (st == ST_P) {
      if (e.decision(21)) return 0;
      if (!e.decision(22)) return 1;
      return e.decision(23) ? 2 : 3;
    }
    if (!e.decision(36)) return 0;
    if (!e.decision(37)) return 1 + e.decision(39);
    int t = 3;
    if (e.decision(38)) {
      if (e.decision(39)) return 11 + e.decision(39);
      t += 4;
    }
    t += 2 * e.decision(39);
    t += e.decision(39);
    return t;
  }
  __device__ int ref_cond(int m_, int b, int lx) {
    if (m_ < 0 || is_skip(m_) || is_intra(m_) || scr(m_)[SC_DIRECT + (b >> 2)]) return 0;
    return refidx(m_, lx, b >> 2) > 0;
  }
  __device__ int cabac_ref(int lx, int blk) {
    int ma, ba, mbb, bb;
    left4(blk, ma, ba);
    top4(blk, mbb, bb);
    int inc = ref_cond(ma, ba, lx) + 2 * ref_cond(mbb, bb, lx);
    int ref = 0;
    while (e.decision(54 + inc)) {
      ref++;
      inc = (inc >> 2) + 4;
      if (ref >= 32) {
        fail(E_RANGE);
        return 0;
      }
    }
    return ref;
  }
  __device__ __forceinline__ int cabac_mvd(int lx, int blk, int comp) {
    int ma, ba, mbb, bb;
    left4(blk, ma, ba);
    top4(blk, mbb, bb);
    int s = (ma >= 0 ? iabs(mvd_of(ma, lx, ba, comp)) : 0) + (mbb >= 0 ? iabs(mvd_of(mbb, lx, bb, comp)) : 0);
    int base = comp == 0 ? 40 : 47;
    int inc = s < 3 ? 0 : (s <= 32 ? 1 : 2);
    if (!e.decision(base + inc)) return 0;
    int m_ = 1, ctx = base + 3;
    while (m_ < 9 && e.decision(ctx)) {
      if (m_ < 4) ctx++;
      m_++;
    }
    if (m_ >= 9) {
      int k = 3;
      while (e.bypass()) {
        m_ += 1 << k;
        if (++k > 24) {
          fail(E_RANGE);
          return 0;
        }
      }
      while (k--) m_ += e.bypass() << k;
    }
    return e.bypass() ? -m_ : m_;
  }
  __device__ int luma_bit(int m_, int k) {
    if (m_ < 0 || type(m_) == T_PCM) return 1;
    return (row(m_)[F_CBP] >> k) & 1;
  }
  __device__ int chroma_of(int m_) {
    if (m_ < 0) return 0;
    if (type(m_) == T_PCM) return 2;
    return row(m_)[F_CBP] >> 4;
  }
  __device__ __forceinline__ int cabac_cbp() {
    int cbp = 0;
    for (int k = 0; k < 4; k++) {
      int x = k & 1, y = k >> 1;
      int ba = x ? (cbp >> (k - 1)) & 1 : luma_bit(mbA, k + 1);
      int bb = y ? (cbp >> (k - 2)) & 1 : luma_bit(mbB, k + 2);
      cbp |= e.decision(73 + (1 - ba) + 2 * (1 - bb)) << k;
    }
    if (!chroma) return cbp;
    int ca = chroma_of(mbA), cb = chroma_of(mbB);
    if (!e.decision(77 + (ca > 0) + 2 * (cb > 0))) return cbp;
    return cbp | ((1 + e.decision(81 + (ca == 2) + 2 * (cb == 2))) << 4);
  }
  __device__ int cabac_dqp() {
    int inc = prev_dqp != 0, n = 0;
    while (e.decision(60 + inc)) {
      inc = inc < 2 ? 2 : 3;
      if (++n > 102) {
        fail(E_RANGE);
        return 0;
      }
    }
    return (n & 1) ? (n + 1) >> 1 : -((n + 1) >> 1);
  }
  __device__ int cpred_cond(int m_) {
    if (m_ < 0) return 0;
    int t = type(m_);
    return (t == T_I4 || t == T_I8 || t == T_I16) && row(m_)[F_CPRED] != 0;
  }
  __device__ int cabac_cpred() {
    if (!e.decision(64 + cpred_cond(mbA) + cpred_cond(mbB))) return 0;
    if (!e.decision(67)) return 1;
    return e.decision(67) ? 3 : 2;
  }
  __device__ int cabac_t8() {
    int inc = (mbA >= 0 && row(mbA)[F_T8]) + (mbB >= 0 && row(mbB)[F_T8]);
    return e.decision(399 + inc);
  }

  // ---- macroblock layer: the type's syntax, then (all but I_PCM) the coded
  // block pattern, the residual and the quantiser, each parsed at one place
  __device__ __forceinline__ void macroblock() {
    int32_t* rw = row(mb);
    int t = cabac ? cabac_mb_type() : e.bs.ue();
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
    int cbp_of = -1, small = 0;  // the coded_block_pattern to read: 1 intra, 0 inter, -1 none
    if (intra >= 0) {
      if (intra > 25) { fail(E_RANGE); return; }
      if (intra == 25) { pcm(); return; }
      if (intra == 0) {
        intra_nxn();
        cbp_of = 1;
      } else {
        int k = intra - 1;
        rw[F_TYPE] = T_I16;
        rw[F_CBP] = (k >= 12 ? 15 : 0) | (((k % 12) / 4) << 4);
        rw[F_I16] = k % 4;
        chroma_mode();
      }
    } else {
      // part: 0-2 16x16 / 16x8 / 8x16 with predictions p0, p1; 3 8x8 sub-macroblocks; 4 B_Direct_16x16
      int part, p0 = 0, p1 = 0, ref0 = 0;
      if (st == ST_P) {
        if (t >= 3) { part = 3; ref0 = t == 4; }
        else if (t == 0) { part = 0; p0 = 1; }
        else { part = t == 1 ? 1 : 2; p0 = p1 = 1; }
      } else if (t == 0) {
        part = 4;
      } else if (t == 22) {
        part = 3;
      } else if (t <= 3) {
        part = 0;
        p0 = t;
      } else {
        const int pairs[9][2] = {{1, 1}, {2, 2}, {1, 2}, {2, 1}, {1, 3}, {2, 3}, {3, 1}, {3, 2}, {3, 3}};
        int k = t - 4;
        part = k % 2 == 0 ? 1 : 2;
        p0 = pairs[k / 2][0];
        p1 = pairs[k / 2][1];
      }
      if (part == 4) {
        rw[F_TYPE] = T_BDIRECT;
        for (int k = 0; k < 4; k++) scr(mb)[SC_DIRECT + k] = 1;
        small = !direct8;
      } else {
        rw[F_TYPE] = T_INTER;
        if (part == 3) small = inter_8x8(ref0);
        else inter_mb(part, p0, p1);
      }
      cbp_of = 0;
    }
    if (cbp_of >= 0) {
      int cbp = coded_block_pattern(cbp_of);
      rw[F_CBP] = cbp;
      if (!cbp_of && (cbp & 15) && t8mode && !small) rw[F_T8] = cabac ? cabac_t8() : e.bs.u(1);
    }
    residual_and_qp();
    finish();
  }

  __device__ int chroma_mode() {
    if (!chroma) return 0;
    int m_ = cabac ? cabac_cpred() : e.bs.ue();
    if (m_ > 3) fail(E_RANGE);
    row(mb)[F_CPRED] = m_;
    return m_;
  }

  __device__ int pred_mode(int blk) {
    int modes[2], k = 0;
    int ms[2], bs2[2];
    left4(blk, ms[0], bs2[0]);
    top4(blk, ms[1], bs2[1]);
    for (int i = 0; i < 2; i++) {
      int m_ = ms[i];
      if (m_ < 0 || (cip && !is_intra(m_))) return 2;
      int t = type(m_);
      modes[k++] = (t == T_I4 || t == T_I8) ? imode_of(m_, bs2[i]) : 2;
    }
    return imin(modes[0], modes[1]);
  }

  // Intra 4x4 / 8x8: the transform flag and the prediction modes
  __device__ __forceinline__ void intra_nxn() {
    int32_t* rw = row(mb);
    int t8 = 0;
    if (t8mode) t8 = cabac ? cabac_t8() : e.bs.u(1);
    rw[F_T8] = t8;
    rw[F_TYPE] = t8 ? T_I8 : T_I4;
    for (int blk = 0; blk < 16; blk += t8 ? 4 : 1) {
      int pred = pred_mode(blk), flag, r = 0;
      if (cabac) {
        flag = e.decision(68);
        if (!flag) {
          r = e.decision(69);
          r |= e.decision(69) << 1;
          r |= e.decision(69) << 2;
        }
      } else {
        flag = e.bs.u(1);
        if (!flag) r = e.bs.u(3);
      }
      int mode = flag ? pred : (r < pred ? r : r + 1);
      for (int b = blk; b < blk + (t8 ? 4 : 1); b++) set_imode(b, mode);
    }
    chroma_mode();
  }

  __device__ int coded_block_pattern(int intra) {
    if (cabac) return cabac_cbp();
    int k = e.bs.ue();
    if (!chroma) {
      if (k > 15) { fail(E_RANGE); return 0; }
      return T(O_CBP400 + (intra ? 16 : 0) + k);
    }
    if (k > 47) { fail(E_RANGE); return 0; }
    return T((intra ? O_CBP_INTRA : O_CBP_INTER) + k);
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
    if (cabac) e.to_reader();
    while (e.bs.pos % 8)
      if (e.bs.u(1)) fail(E_RANGE);
    for (int i = 0; i < n; i++) lv[i] = (int16_t)e.bs.u(8);
    if (cabac) e.start();
    finish();
  }

  __device__ int ref_idx(int lx, int blk) {
    int n = lx ? nref[1] : nref[0];
    if (n == 1) return 0;
    int r;
    if (cabac) r = cabac_ref(lx, blk);
    else r = n == 2 ? 1 - e.bs.bit() : e.bs.ue();
    if (r >= n) fail(E_RANGE);
    return r;
  }

  __device__ void mvd(int lx, const int* blocks, int nb_) {
    int32_t* rw = row(mb);
    for (int c = 0; c < 2; c++) {
      int d = cabac ? cabac_mvd(lx, blocks[0], c) : e.bs.se();
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

  // the partitions' reference indices and motion vector differences
  __device__ __forceinline__ void inter_mb(int part, int p0, int p1) {
    int32_t* rw = row(mb);
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
    rw[F_PART] = part;
    rw[F_PRED] = p0 | (p1 << 2);
  }

  // the sub-macroblocks' types, reference indices and motion vector
  // differences -> whether a partition is smaller than 8x8 (no 8x8 transform)
  __device__ __forceinline__ int inter_8x8(int ref0) {
    int32_t* rw = row(mb);
    int subs[4];
    const int bsubs[13] = {SUB_DIRECT, 4, 8, 12, 1 | 4, 2 | 4, 1 | 8, 2 | 8, 1 | 12, 2 | 12, 3 | 4, 3 | 8, 3 | 12};
    for (int k = 0; k < 4; k++) {
      int s = cabac ? cabac_sub_type() : e.bs.ue();
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
    rw[F_PART] = 3;
    uint32_t sub = 0;
    for (int k = 0; k < 4; k++) sub |= (uint32_t)subs[k] << (5 * k);
    rw[F_SUB] = (int32_t)sub;
    return small;
  }

  __device__ void residual_and_qp() {
    int32_t* rw = row(mb);
    int cbp = rw[F_CBP], i16 = rw[F_TYPE] == T_I16;
    if (cbp || i16) {
      int d = cabac ? cabac_dqp() : e.bs.se();
      if (d < -26 || d > 25) fail(E_RANGE);
      qp = (qp + d + 52) % 52;
      prev_dqp = d;
    } else {
      prev_dqp = 0;
    }
    if (cbp || i16) residual(i16);
  }

  // ---- residual: neighbour state
  __device__ int luma_count(int m_, int b, int* ok) {
    if (m_ < 0) { *ok = 0; return 0; }
    *ok = 1;
    if (type(m_) == T_PCM) return 16;
    return scr(m_)[SC_COUNT + b];
  }
  __device__ int chroma_count(int m_, int c, int comp, int* ok) {
    if (m_ < 0) { *ok = 0; return 0; }
    *ok = 1;
    if (type(m_) == T_PCM) return 16;
    return scr(m_)[SC_CCOUNT + 4 * comp + c];
  }
  __device__ int cbf_luma(int m_, int b) {
    if (m_ < 0) return is_intra(mb);
    int t = type(m_);
    if (t == T_PCM) return 1;
    if (t == T_PSKIP || t == T_BSKIP || !((row(m_)[F_CBP] >> (b >> 2)) & 1)) return 0;
    if (row(m_)[F_T8]) return 1;
    return scr(m_)[SC_COUNT + b] > 0;
  }
  __device__ int cbf_chroma_ac(int m_, int c, int comp) {
    if (m_ < 0) return is_intra(mb);
    int t = type(m_);
    if (t == T_PCM) return 1;
    if (t == T_PSKIP || t == T_BSKIP || (row(m_)[F_CBP] >> 4) != 2) return 0;
    return scr(m_)[SC_CCOUNT + 4 * comp + c] > 0;
  }
  __device__ int cbf_dc(int m_, int which) {
    if (m_ < 0) return is_intra(mb);
    int t = type(m_);
    if (t == T_PCM) return 1;
    if (which == 0) return t == T_I16 ? scr(m_)[SC_DC] : 0;
    if (t == T_PSKIP || t == T_BSKIP || (row(m_)[F_CBP] >> 4) == 0) return 0;
    return scr(m_)[SC_DC + which];
  }

  // each block's coefficients go straight to the macroblock's levels in
  // shared memory: coefficient i to lv[at + zz[zs * i + zo]] (zz null: at +
  // i). The blocks are listed in the standard's order first, so that one
  // call decodes each.
  __device__ __forceinline__ void residual(int i16) {
    int32_t* rw = row(mb);
    int cbp = rw[F_CBP], t8 = rw[F_T8];
    const int* zz4 = Ts + (O_ZZ4 - O_LPS);
    const int* zz8 = Ts + (O_ZZ8 - O_LPS);
    // a block: cat | kind << 3 | b << 5 | comp << 9 | scan << 10 (0 none, 1 4x4, 2 8x8) | (zs == 4) << 12 |
    // zo << 13 | at << 15
    uint32_t list[27];
    int nl = 0;
    auto add = [&](int cat, int kind, int b, int comp, int scan, int zs4, int zo, int at) {
      list[nl++] = (uint32_t)(cat | kind << 3 | b << 5 | comp << 9 | scan << 10 | zs4 << 12 | zo << 13 | at << 15);
    };
    if (i16) add(0, 0, 0, 0, 1, 0, 0, L_DC);
    for (int k = 0; k < 4; k++) {
      if (!((cbp >> k) & 1)) continue;
      if (t8 && cabac) {
        add(5, 0, 4 * k, 0, 2, 0, 0, 64 * k);
        continue;
      }
      for (int b = 4 * k; b < 4 * k + 4; b++) {
        if (i16) add(1, 1, b, 0, 1, 0, 1, 16 * b);
        else if (t8) add(2, 1, b, 0, 2, 1, b - 4 * k, 64 * k);
        else add(2, 1, b, 0, 1, 0, 0, 16 * b);
      }
    }
    if (chroma && (cbp >> 4)) {
      for (int comp = 0; comp < 2; comp++) add(3, 2, comp, comp, 0, 0, 0, L_CDC + 4 * comp);
      if ((cbp >> 4) == 2)
        for (int comp = 0; comp < 2; comp++)
          for (int cc = 0; cc < 4; cc++) add(4, 3, cc, comp, 1, 0, 1, L_CAC + 64 * comp + 16 * cc);
    }
    const uint64_t ns = 0x400F04100F10ull;  // coefficients by category, a byte each
#pragma unroll 1
    for (int j = 0; j < nl; j++) {
      const uint32_t d = list[j];
      const int cat = d & 7, kind = (d >> 3) & 3, b = (d >> 5) & 15, comp = (d >> 9) & 1, scan = (d >> 10) & 3;
      const int* zz = scan == 0 ? nullptr : (scan == 1 ? zz4 : zz8);
      const int cnt = block(cat, (int)((ns >> (8 * cat)) & 0xFF), kind, b, comp, (int)(d >> 15), zz, (d >> 12) & 1 ? 4 : 1,
                            (d >> 13) & 3);
      if (cat == 5)
        for (int bb = b; bb < b + 4; bb++) scr(mb)[SC_COUNT + bb] = (uint8_t)cnt;
    }
  }

  // kind: 0 luma DC, 1 luma 4x4 (b = blk), 2 chroma DC (comp), 3 chroma AC (b = chroma block)
  __device__ __forceinline__ int block(int cat, int n, int kind, int b, int comp, int at, const int* zz, int zs,
                                       int zo) {
    int cnt = cabac ? cabac_block(cat, n, kind, b, comp, at, zz, zs, zo) : cavlc_block(n, kind, b, comp, at, zz, zs, zo);
    uint8_t* s = scr(mb);
    if (kind == 0) s[SC_DC] = cnt > 0;
    else if (kind == 1 && cat != 5) s[SC_COUNT + b] = (uint8_t)cnt;
    else if (kind == 2) s[SC_DC + 1 + comp] = cnt > 0;
    else if (kind == 3) s[SC_CCOUNT + 4 * comp + b] = (uint8_t)cnt;
    return cnt;
  }

  // a prefix code from its lookup table: the symbol of the next bits
  __device__ __forceinline__ int vlc(Bits& bs, int table) {
    bs.steps++;
    const uint32_t peek = bs.peek(16);
    int en = vlcs[vlcs[1 + table] + (peek >> 8)];
    if (en < 0) {
      const int sub = -en;
      en = vlcs[(sub >> 4) + ((peek & 0xFF) >> (8 - (sub & 15)))];
    }
    const int len = en & 0xFF;
    if (!len) {
      fail(E_VLC);
      return 0;
    }
    bs.skip(len);
    return en >> 8;
  }

  __device__ __forceinline__ int cavlc_block(int n, int kind, int b, int comp, int at, const int* zz, int zs, int zo) {
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
    Bits& bs = e.bs;
    int tok = vlc(bs, table == 4 ? V_CDC_TOKEN : V_TOKEN + table);
    int tc = tok >> 2, t1 = tok & 3, cnt = 0;
    if (tc > n) { fail(E_RANGE); return 0; }
    if (!tc) { return 0; }
    int levels[16], runs[16];
    int suffix = (tc > 10 && t1 < 3) ? 1 : 0;
    for (int i = 0; i < tc; i++) {
      if (i < t1) {
        levels[i] = bs.bit() ? -1 : 1;
        continue;
      }
      int prefix = 0;
      bs.steps++;  // a level code
      const int z = __clzll(bs.cache);
      if (!bs.err && z <= 32 && bs.pos + z + 1 <= bs.end) {
        prefix = z;
        bs.skip(z);
        bs.skip(1);
      } else {
        while (bs.bit() == 0) {
          if (++prefix > 32 || bs.err) { fail(E_RANGE); return 0; }
        }
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
    if (tc < n) zeros = vlc(bs, table == 4 ? V_CDC_TZ + tc - 1 : V_TZ + tc - 1);
    if (zeros + tc > n) { fail(E_RANGE); return 0; }
    for (int i = 0; i < tc - 1; i++) {
      int r = 0;
      if (zeros > 0) r = vlc(bs, V_RUN + imin(zeros, 7) - 1);
      if (r > zeros) { fail(E_RANGE); return 0; }
      runs[i] = r;
      zeros -= r;
    }
    runs[tc - 1] = zeros;
    int pos = -1;
    for (int i = tc - 1; i >= 0; i--) {
      pos += runs[i] + 1;
      lv[at + (zz ? zz[zs * pos + zo] : pos)] = (int16_t)levels[i];
      cnt++;
    }
    return cnt;
  }

  __device__ __forceinline__ int cabac_block(int cat, int n, int kind, int b, int comp, int at, const int* zz, int zs,
                                          int zo) {
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
      if (!e.decision(85 + 4 * cat + inc)) return 0;
    }
    // the context bases by category (sig, last, abs): 0-4 packed a byte each, 5 the 8x8 block's
    const uint64_t off = 0x2F2C1D0F00ull, aoff = 0x271E140A00ull;
    const int sig_base = cat == 5 ? 402 : 105 + (int)((off >> (8 * cat)) & 0xFF);
    const int last_base = cat == 5 ? 417 : 166 + (int)((off >> (8 * cat)) & 0xFF);
    const int abs_base = cat == 5 ? 426 : 227 + (int)((aoff >> (8 * cat)) & 0xFF);
    // the significance map as bits, coefficients 0-31 and 32-63; a loop for
    // each way the contexts advance (4x4 and DC blocks, chroma DC, 8x8)
    // The records of position i + 1's significance context and of position
    // i's last context are loaded before position i's significance bin, so
    // that no bin waits on a load; where the next significance context is
    // the same one (8x8 and chroma DC maps), its new record is used.
    uint32_t sig_lo = 0u, sig_hi = 0u;
    int i = 0;
    const int last_i = n - 1;
    uint2 ts = e.state[sig_base], ns, nl;
    if (cat == 5) {
      const int* sig8 = Ts + (O_SIG8 - O_LPS);
      const int* last8 = Ts + (O_LAST8 - O_LPS);
      for (; i < last_i; i++) {
        const int cs = sig_base + sig8[i], cn = sig_base + sig8[i + 1], cl = last_base + last8[i];
        const uint2 tn = e.state[cn], tl = e.state[cl];
        if (e.decision(cs, ts, ns)) {
          if (i < 32) sig_lo |= 1u << i;
          else sig_hi |= 1u << (i - 32);
          if (e.decision(cl, tl, nl)) break;
        }
        ts = cn == cs ? ns : tn;
      }
    } else if (cat == 3) {
      for (; i < last_i; i++) {
        const int cs = sig_base + imin(i, 2), cn = sig_base + imin(i + 1, 2), cl = last_base + imin(i, 2);
        const uint2 tn = e.state[cn], tl = e.state[cl];
        if (e.decision(cs, ts, ns)) {
          sig_lo |= 1u << i;
          if (e.decision(cl, tl, nl)) break;
        }
        ts = cn == cs ? ns : tn;
      }
    } else {
      for (; i < last_i; i++) {
        const uint2 tn = e.state[sig_base + i + 1], tl = e.state[last_base + i];
        if (e.decision(sig_base + i, ts, ns)) {
          sig_lo |= 1u << i;
          if (e.decision(last_base + i, tl, nl)) break;
        }
        ts = tn;
      }
    }
    if (i == last_i) {
      if (i < 32) sig_lo |= 1u << i;
      else sig_hi |= 1u << (i - 32);
    }
    // the levels, last first; the next level's first context is one of two
    // (whether this level is 1 or more), both loaded before this level's bins
    int eq1 = 0, gt1 = 0, cnt = 0;
    const int ctx_gt = abs_base + 5;
    uint2 ta = e.state[abs_base + 1], na;
    for (int w = 1; w >= 0; w--) {
      uint32_t bitsw = w ? sig_hi : sig_lo;
      while (bitsw) {
        const int k = 32 * w + 31 - __clz(bitsw);
        bitsw &= ~(1u << (k & 31));
        int level;
        const int inc = gt1 ? 0 : imin(4, 1 + eq1), inc_one = gt1 ? 0 : imin(4, 2 + eq1);
        const int ctx = ctx_gt + imin(4 - (cat == 3), gt1);  // the level's further bins
        const uint2 t_one = e.state[abs_base + inc_one], t_more = e.state[abs_base], t_gt = e.state[ctx];
        if (!e.decision(abs_base + inc, ta, na)) {
          level = 1;
          eq1++;
          ta = inc_one == inc ? na : t_one;
        } else {
          ta = inc == 0 ? na : t_more;
          // the same context bin after bin: its record stays in a register
          int m_ = 1;
          uint2 tg = t_gt, ng;
          while (m_ < 14 && e.decision(ctx, tg, ng)) {
            tg = ng;
            m_++;
          }
          if (m_ >= 14) {
            int kk = 0;
            while (e.bypass()) {
              m_ += 1 << kk;
              if (++kk > 24) { fail(E_RANGE); return cnt; }
            }
            while (kk--) m_ += e.bypass() << kk;
          }
          level = m_ + 1;
          gt1++;
        }
        lv[at + (zz ? zz[zs * k + zo] : k)] = (int16_t)(e.bypass() ? -level : level);
        cnt++;
      }
    }
    return cnt;
  }

  // ---- the slice, a macroblock a step: the macroblock entered (its slot
  // and levels then ready for the warp to store), or -1; done set at the
  // end. skips: a CAVLC P / B slice's mb_skip_run still to enter, or
  // READ_RUN (the next step reads a run) or CODED (a coded macroblock next)
  static constexpr int READ_RUN = -1, CODED = -2;
  __device__ __forceinline__ int step(int16_t* levels) {
    if (done) return -1;
    if (st != ST_I && !cabac && skips == READ_RUN) {
      if (err || e.bs.err) { end_slice(); return -1; }
      skips = e.bs.ue();
      if (skips <= 0) skips = CODED;
    }
    if (skips > 0) {
      if (m >= nmb) { fail(E_OVERRUN); end_slice(); return -1; }
      enter(m, levels);
      skip_mb();
      m++;
      if (--skips == 0) {
        skips = CODED;
        if (!more_rbsp_data()) end_slice();
      }
      return mb;
    }
    if (!cabac && st != ST_I) skips = READ_RUN;
    else if (err || e.bs.err) { end_slice(); return -1; }
    if (m >= nmb) { fail(E_OVERRUN); end_slice(); return -1; }
    enter(m, levels);
    if (st != ST_I && cabac && mb_skip_flag()) skip_mb();
    else macroblock();
    m++;
    if (!cabac) {
      if (!more_rbsp_data()) end_slice();
    } else {
      const int last = e.terminate();
      e.settle();
      if (last) end_slice();
    }
    return mb;
  }
  __device__ void end_slice() {
    done = 1;
    if (e.bs.err && !err) err = e.bs.err;
    if (!err && !cabac && more_rbsp_data()) err = E_TRAILING;
  }
};

// lanes other than 0 stage the next bytes of the slice into L1 ahead of
// lane 0's reader
__device__ __forceinline__ void prefetch_l1(const void* p) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
#else
  (void)p;
#endif
}

// h264_parse_kernel: a warp per slice (grid-stride over the batch's
// slices). Lane 0 runs the slice's chain of bins and symbols a macroblock a
// step: the bitstream through a register window, the tables, context
// states, the neighbour state of the current and previous rows of
// macroblocks (a ring of slots) and the macroblock's levels in shared
// memory. After each step the warp stores the macroblock's table row,
// scratch and levels in one coalesced pass (the levels double-buffered, so
// lane 0 parses the next macroblock meanwhile) and the other lanes
// prefetch the bytes ahead. Every loop over lanes strides by blockDim.x
// (1 to 32 threads).
__global__ void h264_parse_kernel(const uint8_t* bits, const int32_t* slices, int nslice, const int32_t* tables,
                                  int nvlc, int mbw_max, int32_t* tab, int16_t* lev, uint8_t* scratch, int pic_mbs,
                                  int32_t* status, int32_t* steps) {
  DYNAMIC_SHARED(smem);
  const ParseLayout L(nvlc, mbw_max);
  uint2* ctab = (uint2*)(smem + L.ctab);
  uint2* state = (uint2*)(smem + L.state);
  int* ts = (int*)(smem + L.ts);
  int* vlcs = (int*)(smem + L.vlc);
  int16_t* lbuf = (int16_t*)(smem + L.levels);
  int* info = (int*)(smem + L.info);
  const int lane = threadIdx.x, nt = blockDim.x;
  const unsigned warp = nt >= 32 ? 0xFFFFFFFFu : (1u << nt) - 1;  // the block's lanes
  for (int s = lane; s < 128; s += nt) {
    const int p = s >> 1, mps = s & 1;
    uint32_t lps4 = 0;
    for (int q = 0; q < 4; q++) lps4 |= (uint32_t)tables[O_LPS + p * 4 + q] << (8 * q);
    const int on_mps = (tables[O_MPS + p] << 1) | mps;
    const int on_lps = (tables[O_LPSN + p] << 1) | (p == 0 ? 1 - mps : mps);
    ctab[s] = make_uint2(lps4, (uint32_t)(on_mps | (on_lps << 8) | (mps << 16)));
  }
  for (int i = lane; i < N_TS; i += nt) ts[i] = tables[O_LPS + i];
  for (int i = lane; i < nvlc; i += nt) vlcs[i] = tables[N_TABLES + i];
  for (int i = lane; i < N_LEVELS; i += nt) ((int*)lbuf)[i] = 0;  // 2 x N_LEVELS int16
  for (int si = blockIdx.x; si < nslice; si += gridDim.x) {
    const int32_t* sl = slices + (int64_t)si * S_FIELDS;
    const int st = sl[S_TYPE], cabac = sl[S_CABAC];
    __syncwarp(warp);  // the tables in place; the previous slice's last levels stored and cleared
    if (cabac) {
      const int* init = tables + O_CABAC + (st == ST_I ? 3 : sl[S_IDC]) * 2048;
      const int q = clip3(0, 51, sl[S_QP]);
      for (int k = lane; k < 1024; k += nt) {
        int pre = clip3(1, 126, ((init[2 * k] * q) >> 4) + init[2 * k + 1]);
        state[k] = ctab[pre <= 63 ? (63 - pre) << 1 : ((pre - 64) << 1) | 1];
      }
    }
    const int pic = sl[S_PIC], nbytes = sl[S_BYTES];
    const uint8_t* data = bits + sl[S_OFFSET];
    int32_t* ptab = tab + (int64_t)pic * pic_mbs * N_FIELDS;
    int16_t* plev = lev + (int64_t)pic * pic_mbs * N_LEVELS;
    uint8_t* pscr = scratch + (int64_t)pic * pic_mbs * N_SCRATCH;
    Parser p;
    if (lane == 0) {
      p.Ts = ts;
      p.vlcs = vlcs;
      p.ring = smem + L.ring;
      p.e.ctab = ctab;
      p.e.state = state;
      p.e.steps = 0;
      p.e.bs.start(data, sl[S_BIT], nbytes);
      p.slice_index = sl[S_INDEX];
      p.first = sl[S_FIRST];
      p.st = st;
      p.cabac = cabac;
      p.cip = sl[S_CIP];
      p.t8mode = sl[S_T8MODE];
      p.direct8 = sl[S_DIRECT8];
      p.chroma = sl[S_CHROMA];
      p.mbw = sl[S_MBW];
      p.mbh = sl[S_MBH];
      p.nmb = p.mbw * p.mbh;
      p.nslot = p.mbw + 1;
      p.nref[0] = sl[S_NREF0];
      p.nref[1] = sl[S_NREF1];
      p.err = 0;
      p.mb = p.first;
      p.cur = 0;
      p.qp = sl[S_QP];
      p.prev_dqp = 0;
      p.m = p.first;
      p.skips = Parser::READ_RUN;
      p.done = 0;
      // the RBSP's stop bit: data precede it
      int last = nbytes - 1;
      while (last >= 0 && data[last] == 0) last--;
      p.stop = -1;
      if (last >= 0) {
        int tz = 0;
        while (!((data[last] >> tz) & 1)) tz++;
        p.stop = last * 8 + 7 - tz;
      }
      if (cabac) {
        while (p.e.bs.pos % 8)
          if (p.e.bs.u(1) != 1) { p.fail(E_RANGE); p.done = 1; break; }
      }
    }
    __syncwarp(warp);  // the context states
    if (lane == 0 && cabac && !p.done) p.e.start();
    for (int it = 0;; it++) {
      int16_t* lb = lbuf + (it & 1) * N_LEVELS;
      int* in = info + (it & 1) * 4;
      if (lane == 0) {
        in[0] = p.step(lb);
        in[1] = p.done;
        in[2] = p.e.bs.pos >> 3;
        if (p.done) {
          status[2 * si] = p.err;
          status[2 * si + 1] = p.e.bs.pos;
          if (steps) steps[si] = p.e.chain_steps();
        }
      }
      __syncwarp(warp);
      const int m = in[0], done = in[1];
      if (m >= 0) {
        const int32_t* src = (const int32_t*)(smem + L.ring + ((m - sl[S_FIRST]) % (sl[S_MBW] + 1)) * SLOT_BYTES);
        int32_t* dst = ptab + (int64_t)m * N_FIELDS;
        for (int i = lane; i < N_FIELDS; i += nt) dst[i] = src[i];
        uint32_t* sdst = (uint32_t*)(pscr + (int64_t)m * N_SCRATCH);
        for (int i = lane; i < N_SCRATCH / 4; i += nt) sdst[i] = ((const uint32_t*)(src + N_FIELDS))[i];
        int* lsrc = (int*)lb;
        int* ldst = (int*)(plev + (int64_t)m * N_LEVELS);
        for (int i = lane; i < N_LEVELS / 2; i += nt) {
          ldst[i] = lsrc[i];
          lsrc[i] = 0;
        }
      }
      if (done) break;
      if (lane > 0) prefetch_l1(data + imax(0, imin(in[2] + 128 * lane, nbytes - 1)));
    }
  }
}

// ================================================================== reconstruction

// per-slice records (h264_cuda.RECORD words; the POCs at 80-143 are the host's)
enum { R_TYPE, R_SPATIAL, R_WEIGHTED, R_LDENOM, R_CDENOM, R_CIP, R_DIRECT8, R_CBOFF, R_CROFF, R_DBIDC, R_DBA, R_DBB,
       R_NREF0, R_NREF1 };
constexpr int R_SLOT = 16, R_LONG = 144, R_PID = 208, R_WEIGHTS = 272, R_IMPLICIT = 656, R_DSF = 1680,
              R_LS4 = 1712, R_LS8 = 2288, R_SIZE = 3056;
constexpr int NO_DSF = 1 << 20;
// residual words a macroblock: luma 16x16 raster, then Cb and Cr 8x8
constexpr int N_RES = 384;

// ---- rows of macroblocks across blocks (h264_mv_kernel, h264_intra_kernel,
// h264_filter_kernel): sync[0] is the ticket that hands out rows in order,
// sync[1 + y] how many macroblocks of row y are done, stored after the
// row's writes are fenced; row y reads row y - 1 with acquire order.
// A row waits only on a row with a smaller ticket, taken by a block that is
// running, so the grid needs no co-residency to finish; it is sized to what
// is co-resident only so that no block idles. What another block wrote in
// the same launch is read from L2 (__ldcg): the SM's L1 may hold a stale
// copy of a line that a neighbour row changed since.
__device__ __forceinline__ int ld_acquire(const int* p) {
#ifdef __CUDA_ARCH__
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
#else
  return __atomic_load_n(p, __ATOMIC_ACQUIRE);
#endif
}

__device__ __forceinline__ void st_relaxed(int* p, int v) {
#ifdef __CUDA_ARCH__
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
#else
  __atomic_store_n(p, v, __ATOMIC_RELAXED);
#endif
}

// the next row for this block, the same in every thread (mbh when none is left)
__device__ int take_row(int* sync) {
  __shared__ int row;
  __syncthreads();  // every thread has read the previous row
  if (threadIdx.x == 0) row = atomicAdd(sync, 1);
  __syncthreads();
  return row;
}

// thread 0 states that the macroblocks of row y before x are done where it
// has not yet (`done`, its last statement; nothing was written since the
// last fence), then waits until row y - 1 has done `need`; every thread
// returns after
__device__ void wait_row(int* sync, int y, int x, int need, int& done) {
  if (threadIdx.x == 0) {
    if (done < x) st_relaxed(sync + 1 + y, done = x);
    if (y > 0)
      while (ld_acquire(sync + y) < need) {
      }
  }
  __syncthreads();
}

// every thread's writes of macroblock x of row y made visible to the card
// (a fence each: it returns when they are), then thread 0 stores its progress
__device__ void done_row(int* sync, int y, int x, int& done) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) st_relaxed(sync + 1 + y, done = x + 1);
}

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
  int32_t* res;                         // the residual of intra macroblocks (N_RES words each)
  int* sync;                            // 1 + mbh words, zeroed before each row kernel
};

struct Nb {
  int ok, ref, mx, my;
};

__device__ int read_ref(const int32_t* row, int lx, int k) {
  int r = (row[F_REF0 + lx] >> (8 * k)) & 0xFF;
  return r == 0xFF ? -1 : r;
}

__device__ int imedian(int a, int b, int c) { return imax(imin(a, b), imin(imax(a, b), c)); }

// what h264_mv_kernel reads of a macroblock's neighbourhood, staged in shared
// memory by the block's threads at once (one round trip to L2 instead of a
// chain of dependent loads): ref, mv x, mv y of each 4x4 block and list
struct MvCache {
  int row[N_FIELDS];  // the macroblock's table row
  int slice[4];       // the slices of A (left), B (top), C (top-right), D (top-left); -1 outside the picture
  int top[2][6][3];   // the 4x4 blocks above, x4 - 1 .. x4 + 4
  int left[2][4][3];  // the 4x4 blocks to the left, y4 .. y4 + 3
  int cur[2][16][4];  // the macroblock's own as they are derived, and their picture ids
};

struct Mv {
  const Pic* P;
  MvCache* C;
  int mb, slice, mbx4, mby4;
  uint16_t done;  // the current macroblock's 4x4 blocks done
  // availability by address, as the standard has it: the same slice, and
  // earlier in decoding order (within the macroblock, a block done)
  __device__ Nb nb(int x4, int y4, int lx) const {
    Nb n = {0, -1, 0, 0};
    if (x4 < 0 || y4 < 0 || x4 >= P->w4 || y4 >= P->h4) return n;
    int dx = (x4 >> 2) - (mbx4 >> 2), dy = (y4 >> 2) - (mby4 >> 2);
    const int* v;
    if (dy == 0 && dx == 0) {
      if (!((done >> blk_at(y4 & 3, x4 & 3)) & 1)) return n;
      v = C->cur[lx][blk_at(y4 & 3, x4 & 3)];
    } else if (dy == 0 && dx == -1) {
      if (C->slice[0] != slice) return n;
      v = C->left[lx][y4 - mby4];
    } else if (dy == -1) {
      if (C->slice[dx == 0 ? 1 : (dx > 0 ? 2 : 3)] != slice) return n;
      v = C->top[lx][x4 - mbx4 + 1];
    } else {
      return n;  // later in decoding order
    }
    n.ok = 1;
    if (v[0] < 0) return n;
    n.ref = v[0];
    n.mx = v[1];
    n.my = v[2];
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
    C->cur[lx][blk][0] = ref;
    C->cur[lx][blk][1] = mx;
    C->cur[lx][blk][2] = my;
    C->cur[lx][blk][3] = pid;
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

// h264_mv_kernel: the motion field, rows of macroblocks over the grid, a
// block (a warp) a row. A macroblock that predicts from its neighbours (every
// inter one but temporal direct, which reads only the co-located picture)
// waits until the row above has done x + 1; the threads then stage its
// table row, its neighbours' slices and the motion of the 4x4 blocks above
// and to its left in shared memory, and thread 0 derives its vectors from
// there; the threads then write the macroblock's motion field out.
__global__ void h264_mv_kernel(Pic P) {
  __shared__ MvCache cache;
  const int tid = threadIdx.x, nt = blockDim.x;
  int* sync = P.sync;
  constexpr int ITEMS = N_FIELDS + 4 + 2 * 10 * 3;  // the table row, the neighbours' slices, their motion
  for (int y = take_row(sync); y < P.mbh; y = take_row(sync)) {
    int done = 0;
    for (int x = 0; x < P.mbw; x++) {
      const int mb = y * P.mbw + x;
      const int32_t* grow = P.tab + (int64_t)mb * N_FIELDS;
      const int32_t* rec = P.rec + (int64_t)grow[F_SLICE] * R_SIZE;
      const int t = grow[F_TYPE];
      const int near = t > T_PCM && !((t == T_BSKIP || t == T_BDIRECT) && !rec[R_SPATIAL]);
      if (near) wait_row(sync, y, x, imin(x + 2, P.mbw), done);
      const int x4 = 4 * x, y4 = 4 * y;
      // each thread issues its loads, then stores them (one round trip to L2)
      for (int base = 0; base < ITEMS; base += 5 * nt) {
        int v[5];
#pragma unroll
        for (int k = 0; k < 5; k++) {
          const int i = base + tid + k * nt;
          v[k] = -1;
          if (i < N_FIELDS) {
            v[k] = grow[i];
          } else if (i < N_FIELDS + 4) {
            int q = i - N_FIELDS;  // A, B, C, D
            int nx = x + (q == 0 || q == 3 ? -1 : (q == 2 ? 1 : 0)), ny = y - (q == 0 ? 0 : 1);
            if (nx >= 0 && ny >= 0 && nx < P.mbw) v[k] = P.tab[(int64_t)(ny * P.mbw + nx) * N_FIELDS + F_SLICE];
          } else if (i < ITEMS) {
            int j = i - N_FIELDS - 4, lx = j / 30, e = (j / 3) % 10, c = j % 3;
            int bx = e < 6 ? x4 - 1 + e : x4 - 1, by = e < 6 ? y4 - 1 : y4 + e - 6;
            if (c) v[k] = 0;
            if (near && bx >= 0 && by >= 0 && bx < P.w4) {
              int64_t q = ((int64_t)lx * P.h4 + by) * P.w4 + bx;
              v[k] = c == 0 ? __ldcg(P.ref + q) : __ldcg(P.mv + 2 * q + c - 1);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < 5; k++) {
          const int i = base + tid + k * nt;
          if (i < N_FIELDS) {
            cache.row[i] = v[k];
          } else if (i < N_FIELDS + 4) {
            cache.slice[i - N_FIELDS] = v[k];
          } else if (i < ITEMS) {
            int j = i - N_FIELDS - 4, lx = j / 30, e = (j / 3) % 10, c = j % 3;
            if (e < 6) cache.top[lx][e][c] = v[k];
            else cache.left[lx][e - 6][c] = v[k];
          }
        }
      }
      for (int i = tid; i < 2 * 16 * 4; i += nt)  // no references until derived (intra: none)
        cache.cur[i / 64][(i / 4) & 15][i % 4] = i % 4 == 0 || i % 4 == 3 ? -1 : 0;
      __syncthreads();
      if (tid == 0) {
        Mv M;
        M.P = &P;
        M.C = &cache;
        M.mb = mb;
        M.slice = cache.row[F_SLICE];
        M.mbx4 = x4;
        M.mby4 = y4;
        M.done = 0;
        derive_mb(P, mb, cache.row, rec, M);
      }
      __syncthreads();
      for (int i = tid; i < 2 * 16; i += nt) {
        const int lx = i >> 4, b = i & 15;
        const int64_t q = ((int64_t)lx * P.h4 + y4 + blk_y(b)) * P.w4 + x4 + blk_x(b);
        const int* c = cache.cur[lx][b];
        P.ref[q] = c[0];
        P.mv[2 * q] = c[1];
        P.mv[2 * q + 1] = c[2];
        P.rid[q] = c[3];
      }
      done_row(sync, y, x, done);  // (its barrier: the cache is the next macroblock's)
    }
  }
}

// ---- transforms and prediction helpers
__device__ __forceinline__ void idct4_1d(int a0, int a1, int a2, int a3, int o[4]) {
  int e = a0 + a2, f = a0 - a2, g = (a1 >> 1) - a3, h = a1 + (a3 >> 1);
  o[0] = e + h;
  o[1] = f + g;
  o[2] = f - g;
  o[3] = e - h;
}

__device__ __forceinline__ void idct8_1d(int x[8]) {
  int a0 = x[0] + x[4], a4 = x[0] - x[4], a2 = (x[2] >> 1) - x[6], a6 = x[2] + (x[6] >> 1);
  int b0 = a0 + a6, b2 = a4 + a2, b4 = a4 - a2, b6 = a0 - a6;
  int a1 = -x[3] + x[5] - x[7] - (x[7] >> 1);
  int a3 = x[1] + x[7] - x[3] - (x[3] >> 1);
  int a5 = -x[1] + x[7] + x[5] + (x[5] >> 1);
  int a7 = x[3] + x[5] + x[1] + (x[1] >> 1);
  int b1 = a1 + (a7 >> 2), b7 = a7 - (a1 >> 2), b3 = a3 + (a5 >> 2), b5 = (a3 >> 2) - a5;
  x[0] = b0 + b7; x[1] = b2 + b5; x[2] = b4 + b3; x[3] = b6 + b1;
  x[4] = b6 - b1; x[5] = b4 - b3; x[6] = b2 - b5; x[7] = b0 - b7;
}

__device__ int deq4(int c, int ls, int qp) {
  int q6 = qp / 6;
  return qp >= 24 ? (c * ls) << (q6 - 4) : (c * ls + (1 << (3 - q6))) >> (4 - q6);
}

__device__ int deq8(int c, int ls, int qp) {
  int q6 = qp / 6;
  return qp >= 36 ? (c * ls) << (q6 - 6) : (c * ls + (1 << (5 - q6))) >> (6 - q6);
}

// the Intra16x16 DC coefficient of the 4x4 block at (i, j) of the DC matrix:
// the Hadamard transform of the DC levels, dequantised
__device__ int i16_dc(const int16_t* dcl, int i, int j, int ls0, int qp) {
  const int H[4][4] = {{1, 1, 1, 1}, {1, 1, -1, -1}, {1, -1, -1, 1}, {1, -1, 1, -1}};
  int f = 0;
  for (int k = 0; k < 4; k++) {
    int s = 0;
    for (int l = 0; l < 4; l++) s += dcl[k * 4 + l] * H[l][j];
    f += H[i][k] * s;
  }
  return deq8(f, ls0, qp);
}

__device__ int luma_sample(const uint8_t* p, int stride, int w, int h, int x, int y) {
  return p[clip3(0, h - 1, y) * stride + clip3(0, w - 1, x)];
}

// quarter-sample luma at (i, j) of a 4x4 block from its 9x9 window (the
// block's first sample at (2, 2)), fraction (fx, fy); only the half-sample
// values the position needs are computed, and a whole or one-way fraction
// reads only the window's middle rows or columns
__device__ int luma_qpel(const uint8_t* w, int i, int j, int fx, int fy) {
#define W_(r, c) ((int)w[(r) * 9 + (c)])
#define TAP(a, b, c, d, e, f) ((a) - 5 * (b) + 20 * (c) + 20 * (d) - 5 * (e) + (f))
#define ROW(r) TAP(W_(r, j), W_(r, j + 1), W_(r, j + 2), W_(r, j + 3), W_(r, j + 4), W_(r, j + 5))
#define COL(c) TAP(W_(i, c), W_(i + 1, c), W_(i + 2, c), W_(i + 3, c), W_(i + 4, c), W_(i + 5, c))
  auto G = [&] { return W_(i + 2, j + 2); };
  auto b = [&] { return clip1((ROW(i + 2) + 16) >> 5); };
  auto s = [&] { return clip1((ROW(i + 3) + 16) >> 5); };
  auto hh = [&] { return clip1((COL(j + 2) + 16) >> 5); };
  auto m = [&] { return clip1((COL(j + 3) + 16) >> 5); };
  auto jj = [&] { return clip1((TAP(ROW(i), ROW(i + 1), ROW(i + 2), ROW(i + 3), ROW(i + 4), ROW(i + 5)) + 512) >> 10); };
  switch (fy * 4 + fx) {
    case 0: return G();
    case 4: return (G() + hh() + 1) >> 1;
    case 8: return hh();
    case 12: return (W_(i + 3, j + 2) + hh() + 1) >> 1;
    case 1: return (G() + b() + 1) >> 1;
    case 5: return (b() + hh() + 1) >> 1;
    case 9: return (hh() + jj() + 1) >> 1;
    case 13: return (hh() + s() + 1) >> 1;
    case 2: return b();
    case 6: return (b() + jj() + 1) >> 1;
    case 10: return jj();
    case 14: return (jj() + s() + 1) >> 1;
    case 3: return (W_(i + 2, j + 3) + b() + 1) >> 1;
    case 7: return (b() + m() + 1) >> 1;
    case 11: return (jj() + m() + 1) >> 1;
    default: return (m() + s() + 1) >> 1;
  }
#undef COL
#undef ROW
#undef TAP
#undef W_
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

// h264_inter_kernel: every macroblock at once, a block a macroblock (the
// grid strides when smaller). Step 1, threads over transform rows and
// window samples: the levels dequantised and transformed along rows, and
// for an inter macroblock each 4x4 block's reference windows (9x9 luma,
// 3x3 chroma per list in use, clamped at the picture's edge) staged in
// shared memory. Step 2, a thread a sample: the column transform gives its
// residual; an inter macroblock's sample is predicted from the windows
// (6-tap quarter-sample luma, bilinear chroma), weighted, added and
// clipped; an intra macroblock's residual goes to P.res for
// h264_intra_kernel. I_PCM waits for h264_intra_kernel. The shared arrays
// alternate between two copies from one macroblock to the next, so one
// barrier a macroblock orders step 1 after the reads of two before.
__global__ void h264_inter_kernel(Pic P) {
  __shared__ int coef_[2][N_RES];           // after the row transform, at the levels' positions
  __shared__ uint8_t win_[2][2][16][81];    // luma windows by list and 4x4 block
  __shared__ uint8_t cwin_[2][2][2][16][9]; // chroma windows by list, plane and 4x4 block
  const int tid = threadIdx.x, nt = blockDim.x;
  const int W = 16 * P.mbw, H = 16 * P.mbh;
  int buf = 0;
  for (int mb = blockIdx.x; mb < P.mbw * P.mbh; mb += gridDim.x) {
    const int32_t* row = P.tab + (int64_t)mb * N_FIELDS;
    const int16_t* lv = P.lev + (int64_t)mb * N_LEVELS;
    const int32_t* rec = P.rec + (int64_t)row[F_SLICE] * R_SIZE;
    const int t = row[F_TYPE], qp = row[F_QP], intra = t <= T_PCM, t8 = row[F_T8];
    const int mx = mb % P.mbw, my = mb / P.mbw;
    if (t == T_PCM) continue;  // the same in every thread
    int* coef = coef_[buf];
    uint8_t(*win)[16][81] = win_[buf];
    uint8_t(*cwin)[2][16][9] = cwin_[buf];
    buf ^= 1;
    const int* ls4 = rec + R_LS4;  // [6 lists][6][16]
    // ---- step 1
    if (t8) {
      const int* ls = rec + R_LS8 + ((intra ? 0 : 1) * 6 + qp % 6) * 64;
      for (int i = tid; i < 32; i += nt) {  // 8x8 block k, row r
        int k = i >> 3, r = i & 7, x[8];
#pragma unroll
        for (int c = 0; c < 8; c++) x[c] = deq8(lv[64 * k + 8 * r + c], ls[8 * r + c], qp);
        idct8_1d(x);
#pragma unroll
        for (int c = 0; c < 8; c++) coef[64 * k + 8 * r + c] = x[c];
      }
    } else {
      const int* ls = ls4 + ((intra ? 0 : 3) * 6 + qp % 6) * 16;
      for (int i = tid; i < 64; i += nt) {  // 4x4 block b, row r
        int b = i >> 2, r = i & 3, d[4], o[4];
#pragma unroll
        for (int c = 0; c < 4; c++) d[c] = deq4(lv[16 * b + 4 * r + c], ls[4 * r + c], qp);
        if (t == T_I16 && r == 0) d[0] = i16_dc(lv + L_DC, blk_y(b), blk_x(b), ls[0], qp);
        idct4_1d(d[0], d[1], d[2], d[3], o);
#pragma unroll
        for (int c = 0; c < 4; c++) coef[16 * b + 4 * r + c] = o[c];
      }
    }
    if (P.chroma)
      for (int i = tid; i < 32; i += nt) {  // plane comp, 4x4 block k, row r
        int comp = i >> 4, k = (i >> 2) & 3, r = i & 3, d[4], o[4];
        int qpc = P.T[O_CQP + clip3(0, 51, qp + rec[R_CBOFF + comp])];
        const int* ls = ls4 + (((intra ? 1 : 4) + comp) * 6 + qpc % 6) * 16;
        const int16_t* cl = lv + L_CAC + 64 * comp + 16 * k;
#pragma unroll
        for (int c = 0; c < 4; c++) d[c] = deq4(cl[4 * r + c], ls[4 * r + c], qpc);
        if (r == 0) {
          const int16_t* dc = lv + L_CDC + 4 * comp;
          int f = k == 0 ? dc[0] + dc[1] + dc[2] + dc[3]
                         : (k == 1 ? dc[0] - dc[1] + dc[2] - dc[3]
                                   : (k == 2 ? dc[0] + dc[1] - dc[2] - dc[3] : dc[0] - dc[1] - dc[2] + dc[3]));
          d[0] = ((f * ls[0]) << (qpc / 6)) >> 5;
        }
        idct4_1d(d[0], d[1], d[2], d[3], o);
#pragma unroll
        for (int c = 0; c < 4; c++) coef[256 + 64 * comp + 16 * k + 4 * r + c] = o[c];
      }
    if (!intra) {
      for (int i = tid; i < 2 * 16 * 81; i += nt) {
        int lx = i / (16 * 81), b = (i / 81) & 15, e = i % 81;
        int x4 = 4 * mx + blk_x(b), y4 = 4 * my + blk_y(b);
        int64_t q = ((int64_t)lx * P.h4 + y4) * P.w4 + x4;
        int r = P.ref[q], mvx = P.mv[2 * q], mvy = P.mv[2 * q + 1], wr = e / 9, wc = e % 9;
        // a whole vector component reads the middle 4 of its 9
        if (r < 0 || (!(mvy & 3) && (wr < 2 || wr > 5)) || (!(mvx & 3) && (wc < 2 || wc > 5))) continue;
        const uint8_t* ry = (const uint8_t*)P.refs[3 * rec[R_SLOT + 32 * lx + r]];
        int xi = 4 * x4 + (mvx >> 2) - 2, yi = 4 * y4 + (mvy >> 2) - 2;
        win[lx][b][e] = (uint8_t)luma_sample(ry, P.ys, W, H, xi + wc, yi + wr);
      }
      if (P.chroma)
        for (int i = tid; i < 2 * 2 * 16 * 9; i += nt) {
          int lx = i / (2 * 16 * 9), comp = (i / (16 * 9)) & 1, b = (i / 9) & 15, e = i % 9;
          int x4 = 4 * mx + blk_x(b), y4 = 4 * my + blk_y(b);
          int64_t q = ((int64_t)lx * P.h4 + y4) * P.w4 + x4;
          int r = P.ref[q];
          if (r < 0) continue;
          const uint8_t* pl = (const uint8_t*)P.refs[3 * rec[R_SLOT + 32 * lx + r] + 1 + comp];
          int xi = 2 * x4 + (P.mv[2 * q] >> 3), yi = 2 * y4 + (P.mv[2 * q + 1] >> 3);
          cwin[lx][comp][b][e] = (uint8_t)luma_sample(pl, P.cs, W / 2, H / 2, xi + e % 3, yi + e / 3);
        }
    }
    __syncthreads();
    // ---- step 2
    const int n = P.chroma ? N_RES : 256;
    for (int s = tid; s < n; s += nt) {
      int res, plane, sy, sx, b;
      if (s < 256) {
        plane = 0;
        sy = s >> 4;
        sx = s & 15;
        if (t8) {
          int k = ((sy >> 3) << 1) | (sx >> 3), x[8];
#pragma unroll
          for (int r = 0; r < 8; r++) x[r] = coef[64 * k + 8 * r + (sx & 7)];
          idct8_1d(x);
          int v = 0;
#pragma unroll
          for (int r = 0; r < 8; r++)
            if (r == (sy & 7)) v = x[r];
          res = (v + 32) >> 6;
        } else {
          int bb = blk_at(sy >> 2, sx >> 2), c = sx & 3, o[4];
          idct4_1d(coef[16 * bb + c], coef[16 * bb + 4 + c], coef[16 * bb + 8 + c], coef[16 * bb + 12 + c], o);
          int r = sy & 3;
          res = ((r == 0 ? o[0] : r == 1 ? o[1] : r == 2 ? o[2] : o[3]) + 32) >> 6;
        }
        b = blk_at(sy >> 2, sx >> 2);
      } else {
        int comp = (s - 256) >> 6;
        plane = 1 + comp;
        sy = ((s - 256) >> 3) & 7;
        sx = s & 7;
        int k = ((sy >> 2) << 1) | (sx >> 2), c = sx & 3, o[4];
        const int* cf = coef + 256 + 64 * comp + 16 * k;
        idct4_1d(cf[c], cf[4 + c], cf[8 + c], cf[12 + c], o);
        int r = sy & 3;
        res = ((r == 0 ? o[0] : r == 1 ? o[1] : r == 2 ? o[2] : o[3]) + 32) >> 6;
        b = blk_at(sy >> 1, sx >> 1);
      }
      if (intra) {
        P.res[(int64_t)mb * N_RES + s] = res;
        continue;
      }
      int x4 = 4 * mx + blk_x(b), y4 = 4 * my + blk_y(b);
      int64_t q0 = ((int64_t)0 * P.h4 + y4) * P.w4 + x4, q1 = ((int64_t)1 * P.h4 + y4) * P.w4 + x4;
      int r0 = P.ref[q0], r1 = P.ref[q1];
      int use[2] = {r0 >= 0, r1 >= 0}, p[2] = {0, 0};
      for (int lx = 0; lx < 2; lx++) {
        if (!use[lx]) continue;
        int64_t q = lx ? q1 : q0;
        int mvx = P.mv[2 * q], mvy = P.mv[2 * q + 1];
        if (plane == 0) {
          p[lx] = luma_qpel(win[lx][b], sy & 3, sx & 3, mvx & 3, mvy & 3);
        } else {
          const uint8_t* w = cwin[lx][plane - 1][b];
          int i = sy & 1, j = sx & 1, fx = mvx & 7, fy = mvy & 7;
          p[lx] = ((8 - fx) * (8 - fy) * w[i * 3 + j] + fx * (8 - fy) * w[i * 3 + j + 1] +
                   (8 - fx) * fy * w[i * 3 + 3 + j] + fx * fy * w[i * 3 + 4 + j] + 32) >> 6;
        }
      }
      int mode = rec[R_WEIGHTED];
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
      int v = clip1(weigh(p[0], p[1], use[0], use[1], w0, o0, w1, o1, denom, mode) + res);
      if (plane == 0) P.Y[(int64_t)(16 * my + sy) * P.ys + 16 * mx + sx] = (uint8_t)v;
      else (plane == 1 ? P.U : P.V)[(int64_t)(8 * my + sy) * P.cs + 8 * mx + sx] = (uint8_t)v;
    }
  }
}

// ---- intra prediction, a sample at a time
__device__ int mb_ok_intra(const Pic& P, int mb, int nb) {
  if (nb < 0) return 0;
  const int32_t* r = P.tab + (int64_t)mb * N_FIELDS;
  const int32_t* n = P.tab + (int64_t)nb * N_FIELDS;
  if (n[F_SLICE] != r[F_SLICE] || nb > mb) return 0;
  if (P.rec[(int64_t)r[F_SLICE] * R_SIZE + R_CIP] && n[F_TYPE] > T_PCM) return 0;
  return 1;
}

// Intra4x4 (or, with n = 8, Intra8x8 on the filtered edges) mode `mode` at
// (x, y): top(i) for i in [0, 2n), left(i) for i in [0, n), tl the corner
template <int n, class Top, class Left>
__device__ int intra_nxn(int mode, Top top, Left left, int tl, int x, int y, int dc) {
#define T_(i) ((i) < 0 ? tl : top(i))
#define L_(i) ((i) < 0 ? tl : left(i))
  switch (mode) {
    case 0: return top(x);
    case 1: return left(y);
    case 2: return dc;
    case 3:
      return (x == n - 1 && y == n - 1) ? (top(2 * n - 2) + 3 * top(2 * n - 1) + 2) >> 2
                                        : (top(x + y) + 2 * top(x + y + 1) + top(x + y + 2) + 2) >> 2;
    case 4:
      if (x > y) return (T_(x - y - 2) + 2 * T_(x - y - 1) + T_(x - y) + 2) >> 2;
      if (x < y) return (L_(y - x - 2) + 2 * L_(y - x - 1) + L_(y - x) + 2) >> 2;
      return (T_(0) + 2 * tl + L_(0) + 2) >> 2;
    case 5: {
      int z = 2 * x - y;
      if (z >= 0 && !(z & 1)) return (T_(x - (y >> 1) - 1) + T_(x - (y >> 1)) + 1) >> 1;
      if (z >= 0) return (T_(x - (y >> 1) - 2) + 2 * T_(x - (y >> 1) - 1) + T_(x - (y >> 1)) + 2) >> 2;
      if (z == -1) return (L_(0) + 2 * tl + T_(0) + 2) >> 2;
      if (n == 4) return (L_(y - 1) + 2 * L_(y - 2) + L_(y - 3) + 2) >> 2;
      return (L_(y - 2 * x - 1) + 2 * L_(y - 2 * x - 2) + L_(y - 2 * x - 3) + 2) >> 2;
    }
    case 6: {
      int z = 2 * y - x;
      if (z >= 0 && !(z & 1)) return (L_(y - (x >> 1) - 1) + L_(y - (x >> 1)) + 1) >> 1;
      if (z >= 0) return (L_(y - (x >> 1) - 2) + 2 * L_(y - (x >> 1) - 1) + L_(y - (x >> 1)) + 2) >> 2;
      if (z == -1) return (L_(0) + 2 * tl + T_(0) + 2) >> 2;
      if (n == 4) return (T_(x - 1) + 2 * T_(x - 2) + T_(x - 3) + 2) >> 2;
      return (T_(x - 2 * y - 1) + 2 * T_(x - 2 * y - 2) + T_(x - 2 * y - 3) + 2) >> 2;
    }
    case 7:
      if (!(y & 1)) return (T_(x + (y >> 1)) + T_(x + (y >> 1) + 1) + 1) >> 1;
      return (T_(x + (y >> 1)) + 2 * T_(x + (y >> 1) + 1) + T_(x + (y >> 1) + 2) + 2) >> 2;
    default: {
      int z = x + 2 * y;
      if (z < 2 * n - 3 && !(z & 1)) return (L_(y + (x >> 1)) + L_(y + (x >> 1) + 1) + 1) >> 1;
      if (z < 2 * n - 3) return (L_(y + (x >> 1)) + 2 * L_(y + (x >> 1) + 1) + L_(y + (x >> 1) + 2) + 2) >> 2;
      if (z == 2 * n - 3) return (L_(n - 2) + 3 * L_(n - 1) + 2) >> 2;
      return L_(n - 1);
    }
  }
#undef T_
#undef L_
}

// h264_intra_kernel: the intra macroblocks, after h264_inter_kernel, so
// each reads its inter neighbours' finished samples; rows of macroblocks
// over the grid, a block a row, waiting on the row above only at an intra
// macroblock (a row without one passes straight through). A macroblock's
// neighbourhood (the row above with its top-right, the column to its left)
// and its own samples live in shared memory while its 4x4 / 8x8 blocks are
// predicted in order, the threads over each block's samples.
__global__ void h264_intra_kernel(Pic P) {
  __shared__ int lc[17][25];    // luma: row 0 the samples above (col 0 top-left), col 0 the left ones
  __shared__ int cc[2][9][9];   // chroma, the same way
  __shared__ int f8[25];        // Intra8x8's filtered top (16), left (8) and corner
  __shared__ int prm[3 + 2 * 7];  // Intra16x16 DC or plane a, b, c; chroma a, b, c and four DCs per plane
  __shared__ int res[N_RES];      // the macroblock's residual
  const int tid = threadIdx.x, nt = blockDim.x;
  int* sync = P.sync;
  for (int y = take_row(sync); y < P.mbh; y = take_row(sync)) {
    int done = 0;
    for (int x = 0; x < P.mbw; x++) {
      const int mb = y * P.mbw + x;
      const int32_t* row = P.tab + (int64_t)mb * N_FIELDS;
      const int t = row[F_TYPE];
      if (t > T_PCM) continue;  // the same in every thread
      wait_row(sync, y, x, imin(x + 2, P.mbw), done);
      const int16_t* lv = P.lev + (int64_t)mb * N_LEVELS;
      const int X = 16 * x, Yp = 16 * y, cx = 8 * x, cy = 8 * y;
      uint8_t* Y = P.Y;
      const int ys = P.ys, cs = P.cs;
      if (t == T_PCM) {
        for (int i = tid; i < (P.chroma ? N_RES : 256); i += nt) {
          uint8_t v = (uint8_t)(lv[i] & 0xFF);
          if (i < 256) Y[(int64_t)(Yp + i / 16) * ys + X + i % 16] = v;
          else (i < 320 ? P.U : P.V)[(int64_t)(cy + (i & 63) / 8) * cs + cx + i % 8] = v;
        }
        done_row(sync, y, x, done);
        continue;
      }
      const int A = mb_ok_intra(P, mb, x > 0 ? mb - 1 : -1);
      const int Bn = mb_ok_intra(P, mb, y > 0 ? mb - P.mbw : -1);
      const int C = mb_ok_intra(P, mb, (y > 0 && x < P.mbw - 1) ? mb - P.mbw + 1 : -1);
      const int D = mb_ok_intra(P, mb, (y > 0 && x > 0) ? mb - P.mbw - 1 : -1);
      // ---- the residual, and the neighbourhood (0 where not available)
      for (int i = tid; i < N_RES + 25 + 16 + (P.chroma ? 2 * 17 : 0); i += nt) {
        const int j = i - N_RES;
        if (j < 0) {
          res[i] = P.res[(int64_t)mb * N_RES + i];
        } else if (j < 25) {
          int ok = j == 0 ? D : (j <= 16 ? Bn : C);
          lc[0][j] = ok ? __ldcg(Y + (int64_t)(Yp - 1) * ys + X - 1 + j) : 0;
        } else if (j < 41) {
          lc[j - 24][0] = A ? __ldcg(Y + (int64_t)(Yp + j - 25) * ys + X - 1) : 0;
        } else {
          int comp = (j - 41) / 17, k = (j - 41) % 17;
          const uint8_t* pl = comp ? P.V : P.U;
          if (k < 9) cc[comp][0][k] = (k == 0 ? D : Bn) ? __ldcg(pl + (int64_t)(cy - 1) * cs + cx - 1 + k) : 0;
          else cc[comp][k - 8][0] = A ? __ldcg(pl + (int64_t)(cy + k - 9) * cs + cx - 1) : 0;
        }
      }
      __syncthreads();
      const int cmode = row[F_CPRED];
      if (tid == 0) {
        if (t == T_I16) {
          int mode = row[F_I16];
          if (mode == 2) {
            int st = 0, sl = 0;
            for (int k = 0; k < 16; k++) { st += lc[0][1 + k]; sl += lc[1 + k][0]; }
            prm[0] = Bn && A ? (st + sl + 16) >> 5 : (A ? (sl + 8) >> 4 : (Bn ? (st + 8) >> 4 : 128));
          } else if (mode == 3) {
            int Hs = 0, Vs = 0;
            for (int k = 0; k < 8; k++) {
              Hs += (k + 1) * (lc[0][9 + k] - lc[0][7 - k]);
              Vs += (k + 1) * (lc[9 + k][0] - lc[7 - k][0]);
            }
            prm[0] = 16 * (lc[16][0] + lc[0][16]);
            prm[1] = (5 * Hs + 32) >> 6;
            prm[2] = (5 * Vs + 32) >> 6;
          }
        }
        for (int comp = 0; P.chroma && comp < 2; comp++) {
          int* q = prm + 3 + 7 * comp;
          if (cmode == 3) {
            int Hs = 0, Vs = 0;
            for (int k = 0; k < 4; k++) {
              Hs += (k + 1) * (cc[comp][0][5 + k] - cc[comp][0][3 - k]);
              Vs += (k + 1) * (cc[comp][5 + k][0] - cc[comp][3 - k][0]);
            }
            q[0] = 16 * (cc[comp][8][0] + cc[comp][0][8]);
            q[1] = (34 * Hs + 32) >> 6;
            q[2] = (34 * Vs + 32) >> 6;
          } else if (cmode == 0) {
            for (int by = 0; by < 2; by++)
              for (int bx = 0; bx < 2; bx++) {
                int st = 0, sl = 0, dc;
                for (int k = 0; k < 4; k++) { st += cc[comp][0][1 + 4 * bx + k]; sl += cc[comp][1 + 4 * by + k][0]; }
                if (bx == by) dc = Bn && A ? (st + sl + 4) >> 3 : (A ? (sl + 2) >> 2 : (Bn ? (st + 2) >> 2 : 128));
                else if (bx == 1) dc = Bn ? (st + 2) >> 2 : (A ? (sl + 2) >> 2 : 128);
                else dc = A ? (sl + 2) >> 2 : (Bn ? (st + 2) >> 2 : 128);
                q[3 + 2 * by + bx] = dc;
              }
          }
        }
      }
      __syncthreads();
      // ---- luma into lc[1..16][1..16]
      if (t == T_I16) {
        int mode = row[F_I16];
        for (int s = tid; s < 256; s += nt) {
          int sy = s >> 4, sx = s & 15;
          int p = mode == 0 ? lc[0][1 + sx]
                            : (mode == 1 ? lc[1 + sy][0]
                                         : (mode == 2 ? prm[0] : clip1((prm[0] + prm[1] * (sx - 7) + prm[2] * (sy - 7) + 16) >> 5)));
          lc[1 + sy][1 + sx] = clip1(p + res[s]);
        }
      } else if (t == T_I4) {
        for (int b = 0; b < 16; b++) {
          const int bx = blk_x(b), by = blk_y(b), r0 = 4 * by, c0 = 4 * bx + 1;
          const int mode = (row[b < 8 ? F_IM0 : F_IM1] >> (4 * (b & 7))) & 15;
          const int has_top = by > 0 || Bn, has_left = bx > 0 || A;
          const int has_tl = (by > 0 && bx > 0) ? 1 : (by > 0 ? A : (bx > 0 ? Bn : D));
          const int has_tr = by == 0 ? (bx < 3 ? Bn : C) : (bx < 3 && blk_at(by - 1, bx + 1) < b);
          auto top = [&](int k) { return has_top ? lc[r0][c0 + (k < 4 || has_tr ? k : 3)] : 0; };
          auto left = [&](int k) { return has_left ? lc[r0 + 1 + k][c0 - 1] : 0; };
          const int tl = has_tl ? lc[r0][c0 - 1] : 0;
          for (int s = tid; s < 16; s += nt) {
            int i = s >> 2, j = s & 3, dc = 128;
            if (mode == 2) {
              int st = top(0) + top(1) + top(2) + top(3), sl = left(0) + left(1) + left(2) + left(3);
              dc = has_top && has_left ? (st + sl + 4) >> 3 : (has_left ? (sl + 2) >> 2 : (has_top ? (st + 2) >> 2 : 128));
            }
            int p = intra_nxn<4>(mode, top, left, tl, j, i, dc);
            lc[r0 + 1 + i][c0 + j] = clip1(p + res[(r0 + i) * 16 + c0 - 1 + j]);
          }
          __syncthreads();
        }
      } else {  // T_I8
        for (int k = 0; k < 4; k++) {
          const int bx = k & 1, by = k >> 1, r0 = 8 * by, c0 = 8 * bx + 1;
          const int mode = (row[k < 2 ? F_IM0 : F_IM1] >> (16 * (k & 1))) & 15;
          const int has_top = by > 0 || Bn, has_left = bx > 0 || A;
          const int has_tl = (bx && by) ? 1 : (by ? A : (bx ? Bn : D));
          const int has_tr = by == 0 ? (bx == 0 ? Bn : C) : (bx == 0);
          auto top0 = [&](int q) { return has_top ? lc[r0][c0 + (q < 8 || has_tr ? q : 7)] : 0; };
          auto left0 = [&](int q) { return has_left ? lc[r0 + 1 + q][c0 - 1] : 0; };
          const int tl0 = has_tl ? lc[r0][c0 - 1] : 0;
          for (int i = tid; i < 25; i += nt) {
            int v = 0;
            if (i < 16) {
              if (has_top)
                v = i == 0 ? (has_tl ? (tl0 + 2 * top0(0) + top0(1) + 2) >> 2 : (3 * top0(0) + top0(1) + 2) >> 2)
                           : (i == 15 ? (top0(14) + 3 * top0(15) + 2) >> 2 : (top0(i - 1) + 2 * top0(i) + top0(i + 1) + 2) >> 2);
            } else if (i < 24) {
              int q = i - 16;
              if (has_left)
                v = q == 0 ? (has_tl ? (tl0 + 2 * left0(0) + left0(1) + 2) >> 2 : (3 * left0(0) + left0(1) + 2) >> 2)
                           : (q == 7 ? (left0(6) + 3 * left0(7) + 2) >> 2 : (left0(q - 1) + 2 * left0(q) + left0(q + 1) + 2) >> 2);
            } else if (has_tl) {
              v = has_top && has_left ? (top0(0) + 2 * tl0 + left0(0) + 2) >> 2
                                      : (has_top ? (3 * tl0 + top0(0) + 2) >> 2 : (has_left ? (3 * tl0 + left0(0) + 2) >> 2 : tl0));
            }
            f8[i] = v;
          }
          __syncthreads();
          auto ft = [&](int q) { return f8[q]; };
          auto fl = [&](int q) { return f8[16 + q]; };
          int dc = 128;
          if (mode == 2) {
            int st = 0, sl = 0;
            for (int q = 0; q < 8; q++) {
              if (has_top) st += f8[q];
              if (has_left) sl += f8[16 + q];
            }
            dc = has_top && has_left ? (st + sl + 8) >> 4 : (has_left ? (sl + 4) >> 3 : (has_top ? (st + 4) >> 3 : 128));
          }
          for (int s = tid; s < 64; s += nt) {
            int i = s >> 3, j = s & 7;
            int p = intra_nxn<8>(mode, ft, fl, f8[24], j, i, dc);
            lc[r0 + 1 + i][c0 + j] = clip1(p + res[(r0 + i) * 16 + c0 - 1 + j]);
          }
          __syncthreads();
        }
      }
      __syncthreads();
      // ---- the luma out, chroma predicted and added
      for (int s = tid; s < (P.chroma ? N_RES : 256); s += nt) {
        if (s < 256) {
          Y[(int64_t)(Yp + (s >> 4)) * ys + X + (s & 15)] = (uint8_t)lc[1 + (s >> 4)][1 + (s & 15)];
          continue;
        }
        int comp = (s - 256) >> 6, sy = ((s - 256) >> 3) & 7, sx = s & 7;
        const int* q = prm + 3 + 7 * comp;
        int p = cmode == 0 ? q[3 + 2 * (sy >> 2) + (sx >> 2)]
                           : (cmode == 1 ? cc[comp][1 + sy][0]
                                         : (cmode == 2 ? cc[comp][0][1 + sx] : clip1((q[0] + q[1] * (sx - 3) + q[2] * (sy - 3) + 16) >> 5)));
        (comp ? P.V : P.U)[(int64_t)(cy + sy) * cs + cx + sx] = (uint8_t)clip1(p + res[s]);
      }
      done_row(sync, y, x, done);
    }
    if (tid == 0 && done < P.mbw) st_relaxed(sync + 1 + y, P.mbw);
  }
}

// ================================================================== deblocking

// per macroblock, what h264_bs_kernel hands h264_filter_kernel: bS by
// direction (vertical first), edge and segment (32 bytes), then indexA and
// indexB by direction, edge and plane (luma, Cb, Cr; 48 bytes)
constexpr int DB_BYTES = 80, DB_INDEX = 32;

struct Db {
  const int32_t* tab;
  const int32_t* rec;
  const int32_t *mv, *rid;
  const int32_t* T;
  uint8_t *Y, *U, *V;
  int mbw, mbh, chroma, ys, cs, w4, h4;
  uint8_t* bs;  // DB_BYTES a macroblock: bS, then the filter's indices (h264_bs_kernel)
  int* sync;    // 1 + mbh words, zeroed before h264_filter_kernel
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

// the neighbour across edge 0 of direction `vert`, or -1
__device__ __forceinline__ int edge_nb(const Db& D, int mb, int vert) {
  int mx = mb % D.mbw, my = mb / D.mbw;
  return vert ? (mx > 0 ? mb - 1 : -1) : (my > 0 ? mb - D.mbw : -1);
}

// bS of segment k of edge e of macroblock mb, direction vertical (d 0) or
// horizontal (d 1); 0 where the edge is not filtered
__device__ int strength(const Db& D, int mb, int d, int e, int k) {
  const int32_t* row = D.tab + (int64_t)mb * N_FIELDS;
  const int32_t* rec = D.rec + (int64_t)row[F_SLICE] * R_SIZE;
  int idc = rec[R_DBIDC], vert = d == 0;
  if (idc == 1) return 0;
  int nb = edge_nb(D, mb, vert);
  if (e == 0) {
    if (nb < 0) return 0;
    if (idc == 2 && D.tab[(int64_t)nb * N_FIELDS + F_SLICE] != row[F_SLICE]) return 0;
  } else if (row[F_T8] && (e & 1)) {
    return 0;
  }
  const int32_t* prow = D.tab + (int64_t)(e == 0 ? nb : mb) * N_FIELDS;
  int mx = mb % D.mbw, my = mb / D.mbw;
  int qy = 4 * my + (vert ? k : e), qx = 4 * mx + (vert ? e : k);
  int py = vert ? qy : qy - 1, px = vert ? qx - 1 : qx;
  if (row[F_TYPE] <= T_PCM || prow[F_TYPE] <= T_PCM) return e == 0 ? 4 : 3;
  int nzq = (row[F_NZ] >> blk_at(qy & 3, qx & 3)) & 1, nzp = (prow[F_NZ] >> blk_at(py & 3, px & 3)) & 1;
  return (nzq || nzp) ? 2 : check_mv(D, py, px, qy, qx);
}

// indexA and indexB of the filter of edge e of macroblock mb, direction
// vert, plane (0 luma, 1 Cb, 2 Cr): the average of the two sides' QP (I_PCM's
// taken as 0; for chroma each side's QP_C through its own slice's offset)
// with the current slice's FilterOffsetA / B; 0 where the edge is the picture's
__device__ void edge_index(const Db& D, int mb, int vert, int e, int plane, uint8_t* out) {
  const int nb = e == 0 ? edge_nb(D, mb, vert) : mb;
  if (nb < 0) {
    out[0] = out[1] = 0;
    return;
  }
  const int32_t* row = D.tab + (int64_t)mb * N_FIELDS;
  const int32_t* rec = D.rec + (int64_t)row[F_SLICE] * R_SIZE;
  const int32_t* prow = D.tab + (int64_t)nb * N_FIELDS;
  int qpq = row[F_TYPE] == T_PCM ? 0 : row[F_QP], qpp = prow[F_TYPE] == T_PCM ? 0 : prow[F_QP];
  if (plane) {
    const int32_t* prec = D.rec + (int64_t)prow[F_SLICE] * R_SIZE;
    qpp = D.T[O_CQP + clip3(0, 51, qpp + prec[R_CBOFF + plane - 1])];
    qpq = D.T[O_CQP + clip3(0, 51, qpq + rec[R_CBOFF + plane - 1])];
  }
  int qav = (qpp + qpq + 1) >> 1;
  out[0] = (uint8_t)clip3(0, 51, qav + rec[R_DBA]);
  out[1] = (uint8_t)clip3(0, 51, qav + rec[R_DBB]);
}

// h264_bs_kernel: every edge segment's bS at once, a thread a segment; the
// threads of segments 0-2 of an edge also give its indices for the three
// planes, so the filter's chain of macroblocks reads no table
__global__ void h264_bs_kernel(Db D) {
  const int n = D.mbw * D.mbh * 32;
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < n; g += gridDim.x * blockDim.x) {
    const int mb = g >> 5, d = (g >> 4) & 1, e = (g >> 2) & 3, k = g & 3;
    uint8_t* out = D.bs + (int64_t)mb * DB_BYTES;
    out[g & 31] = (uint8_t)strength(D, mb, d, e, k);
    if (k < 3) edge_index(D, mb, d == 0, e, k, out + DB_INDEX + 2 * ((4 * d + e) * 3 + k));
  }
}

// one line across an edge, q0 at s (samples in shared memory)
__device__ void filter_line(uint8_t* s, int step, int bs, int alpha, int beta, const int* tc0, int chroma) {
  if (bs <= 0) return;
  int p0 = s[-step], p1 = s[-2 * step], q0 = s[0], q1 = s[step];
  if (!(iabs(p0 - q0) < alpha && iabs(p1 - p0) < beta && iabs(q1 - q0) < beta)) return;
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

// h264_filter_kernel: the standard's order, rows of macroblocks over the
// grid, a block a row. A macroblock whose bS are all 0 changes nothing and
// waits for nothing; another waits until the row above has done x + 1,
// stages in shared memory (4-byte words, each thread's loads issued
// together) its samples with the 4 luma (4 chroma) columns to its left and
// rows (2 chroma rows) above, its bS and its edges' parameters, filters its
// vertical edges and then its horizontal ones there (alpha, beta and tC0
// from the bS kernel's indices and the tables, held in shared memory), the
// threads over the 16 luma and 16 chroma lines (a vertical edge changes
// only the samples of its lines, so each line walks the 4 edges in order on
// its own), and writes back the words the filter may have changed (no
// other block writes those samples until this one's progress is stored).
__global__ void h264_filter_kernel(Db D) {
  __shared__ uint32_t lyw[20][5];     // luma rows y - 4 .. y + 15, columns x - 4 .. x + 15
  __shared__ uint32_t lcw[2][10][3];  // chroma rows y - 2 .. y + 7, columns x - 4 .. x + 7
  __shared__ uint32_t bsw[DB_BYTES / 4];  // the bS kernel's bytes of the macroblock
  __shared__ int ftab[52 * 5];            // alpha, beta, tC0 by bS 1-3, by index
  uint8_t(*ly)[20] = (uint8_t(*)[20])lyw;
  uint8_t(*lc)[10][12] = (uint8_t(*)[10][12])lcw;
  const uint8_t* bss = (const uint8_t*)bsw;
  const int tid = threadIdx.x, nt = blockDim.x;
  int* sync = D.sync;
  constexpr int WORDS = 100 + 60 + DB_BYTES / 4;
  for (int i = tid; i < 52 * 5; i += nt)  // (take_row's barrier follows)
    ftab[i] = D.T[i % 5 == 0 ? O_ALPHA + i / 5 : (i % 5 == 1 ? O_BETA + i / 5 : O_TC0 + 3 * (i / 5) + i % 5 - 2)];
  for (int y = take_row(sync); y < D.mbh; y = take_row(sync)) {
    int done = 0;
    for (int x = 0; x < D.mbw; x++) {
      const int mb = y * D.mbw + x;
      const uint32_t* w = (const uint32_t*)(D.bs + (int64_t)mb * DB_BYTES);
      int mask = 0;  // edges with a nonzero bS, bit 4 d + e; the same in every thread
      for (int e = 0; e < 8; e++) mask |= (w[e] != 0) << e;
      if (!mask) continue;
      wait_row(sync, y, x, imin(x + 2, D.mbw), done);
      const int X = 16 * x, Yp = 16 * y, cx = 8 * x, cy = 8 * y;
      for (int base = 0; base < WORDS; base += 6 * nt) {
        uint32_t v[6];
#pragma unroll
        for (int k = 0; k < 6; k++) {
          const int i = base + tid + k * nt;
          v[k] = 0;
          if (i < 100) {
            int r = Yp - 4 + i / 5, c = X - 4 + 4 * (i % 5);
            if (r >= 0 && c >= 0) v[k] = __ldcg((const uint32_t*)(D.Y + (int64_t)r * D.ys + c));
          } else if (i < 160) {
            int j = i - 100, r = cy - 2 + (j % 30) / 3, c = cx - 4 + 4 * (j % 3);
            if (D.chroma && r >= 0 && c >= 0)
              v[k] = __ldcg((const uint32_t*)((j >= 30 ? D.V : D.U) + (int64_t)r * D.cs + c));
          } else if (i < WORDS) {
            v[k] = w[i - 160];
          }
        }
#pragma unroll
        for (int k = 0; k < 6; k++) {
          const int i = base + tid + k * nt;
          if (i < 100) lyw[i / 5][i % 5] = v[k];
          else if (i < 160) lcw[(i - 100) / 30][((i - 100) % 30) / 3][(i - 100) % 3] = v[k];
          else if (i < WORDS) bsw[i - 160] = v[k];
        }
      }
      __syncthreads();
      const int lines = D.chroma ? 32 : 16;
      for (int d = 0; d < 2; d++) {
        for (int l = tid; l < lines; l += nt) {
          const int luma = l < 16, comp = (l - 16) >> 3, cl = (l - 16) & 7;
          for (int e = 0; e < 4; e++) {
            if (!((mask >> (4 * d + e)) & 1) || (!luma && (e & 1))) continue;
            const uint8_t* ix = bss + DB_INDEX + 2 * ((4 * d + e) * 3 + (luma ? 0 : 1 + comp));
            const int* ta = ftab + 5 * ix[0];  // alpha and tC0 by indexA
            const int beta = ftab[5 * ix[1] + 1];
            const uint8_t* bs = bss + 16 * d + 4 * e;
            if (luma) {
              uint8_t* s = d == 0 ? &ly[4 + l][4 + 4 * e] : &ly[4 + 4 * e][4 + l];
              filter_line(s, d == 0 ? 1 : 20, bs[l >> 2], ta[0], beta, ta + 2, 0);
            } else {
              uint8_t* s = d == 0 ? &lc[comp][2 + cl][4 + 2 * e] : &lc[comp][2 + 2 * e][4 + cl];
              filter_line(s, d == 0 ? 1 : 12, bs[cl >> 1], ta[0], beta, ta + 2, 1);
            }
          }
        }
        __syncthreads();
      }
      // back: the macroblock's rows with the word to their left, and the words above it
      for (int i = tid; i < 100 + 60; i += nt) {
        if (i < 100) {
          int r = i / 5, c = i % 5;
          if (r >= 4 ? (c > 0 || x > 0) : (r >= 1 && c > 0 && y > 0))
            *(uint32_t*)(D.Y + (int64_t)(Yp - 4 + r) * D.ys + X - 4 + 4 * c) = lyw[r][c];
        } else if (D.chroma) {
          int j = i - 100, comp = j / 30, r = (j % 30) / 3, c = j % 3;
          if (r >= 2 ? (c > 0 || x > 0) : (r == 1 && c > 0 && y > 0))
            *(uint32_t*)((comp ? D.V : D.U) + (int64_t)(cy - 2 + r) * D.cs + cx - 4 + 4 * c) = lcw[comp][r][c];
        }
      }
      done_row(sync, y, x, done);
    }
    if (tid == 0 && done < D.mbw) st_relaxed(sync + 1 + y, D.mbw);
  }
}

// the threads of a block, at most `natural` and H264_MAX_THREADS
int threads_for(int natural) { return natural < H264_MAX_THREADS ? natural : H264_MAX_THREADS; }

// a grid for `work` blocks of `threads` threads of `kernel`, no larger than
// what is co-resident on the card and H264_MAX_BLOCKS
template <class K>
int grid_for(K kernel, int threads, int work) {
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  long long g = (long long)(per_sm > 1 ? per_sm : 1) * sms;
  if (g > work) g = work;
  if (g > H264_MAX_BLOCKS) g = H264_MAX_BLOCKS;
  return g < 1 ? 1 : (int)g;
}

}  // namespace

extern "C" {

const char* dspnet_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int dspnet_h264_tables_size() { return N_TABLES; }
int dspnet_h264_record_size() { return R_SIZE; }

// the parse of a batch's slices: nvlc words of CAVLC lookup tables follow
// the N_TABLES words of tables; mbw_max the widest picture's macroblocks;
// steps (null, or an int32 a slice) takes each slice's chain steps (CABAC
// bins, or CAVLC codes)
int dspnet_h264_parse(const void* bits, const void* slices, int nslice, const void* tables, int nvlc, int mbw_max,
                      void* tab, void* lev, void* scratch, int pic_mbs, void* status, void* steps, void* stream) {
  if (nslice <= 0) return 0;
  const ParseLayout L(nvlc, mbw_max);
  int err = (int)cudaFuncSetAttribute(h264_parse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err) return err;
  const int grid = nslice < H264_MAX_BLOCKS ? nslice : H264_MAX_BLOCKS;
  H264_LAUNCH_SHARED(h264_parse_kernel, grid, H264_PARSE_THREADS, L.bytes, (cudaStream_t)stream)(
      (const uint8_t*)bits, (const int32_t*)slices, nslice, (const int32_t*)tables, nvlc, mbw_max, (int32_t*)tab,
      (int16_t*)lev, (uint8_t*)scratch, pic_mbs, (int32_t*)status, (int32_t*)steps);
  return (int)cudaGetLastError();
}

// one kernel of the reconstruction: 0 h264_mv_kernel, 1 h264_inter_kernel,
// 2 h264_intra_kernel, launched in that order on the stream; res holds
// N_RES int32 a macroblock, sync 1 + mbh int32 (zeroed here before a row kernel)
int dspnet_h264_recon_stage(int stage, const void* tab, const void* lev, const void* rec, const void* refs,
                            const void* tables, int mbw, int mbh, int chroma, int poc, void* y, void* u, void* v,
                            int ys, int cs, void* mv, void* ref, void* rid, const void* cmv, const void* cref,
                            const void* crid, void* res, void* sync, void* stream) {
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
  P.res = (int32_t*)res;
  P.sync = (int*)sync;
  cudaStream_t st = (cudaStream_t)stream;
  if (stage == 1) {
    int threads = threads_for(256);
    int grid = mbw * mbh < H264_MAX_BLOCKS ? mbw * mbh : H264_MAX_BLOCKS;
    H264_LAUNCH(h264_inter_kernel, grid, threads, st)(P);
    return (int)cudaGetLastError();
  }
  int err = (int)cudaMemsetAsync(sync, 0, sizeof(int) * (1 + mbh), st);
  if (err) return err;
  if (stage == 0) {
    int threads = threads_for(32);
    H264_LAUNCH(h264_mv_kernel, grid_for(h264_mv_kernel, threads, mbh), threads, st)(P);
  } else {
    int threads = threads_for(256);
    H264_LAUNCH(h264_intra_kernel, grid_for(h264_intra_kernel, threads, mbh), threads, st)(P);
  }
  return (int)cudaGetLastError();
}

// one kernel of the deblocking filter: 0 h264_bs_kernel, 1
// h264_filter_kernel (in place); bs holds DB_BYTES a macroblock, sync 1 + mbh int32
int dspnet_h264_deblock_stage(int stage, const void* tab, const void* rec, const void* mv, const void* rid,
                              const void* tables, int mbw, int mbh, int chroma, void* y, void* u, void* v, int ys,
                              int cs, void* bs, void* sync, void* stream) {
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
  D.bs = (uint8_t*)bs;
  D.sync = (int*)sync;
  cudaStream_t st = (cudaStream_t)stream;
  if (stage == 0) {
    int threads = threads_for(256), segments = mbw * mbh * 32;
    int grid = (segments + threads - 1) / threads;
    H264_LAUNCH(h264_bs_kernel, grid < H264_MAX_BLOCKS ? grid : H264_MAX_BLOCKS, threads, st)(D);
    return (int)cudaGetLastError();
  }
  int err = (int)cudaMemsetAsync(sync, 0, sizeof(int) * (1 + mbh), st);
  if (err) return err;
  int threads = threads_for(32);
  H264_LAUNCH(h264_filter_kernel, grid_for(h264_filter_kernel, threads, mbh), threads, st)(D);
  return (int)cudaGetLastError();
}

}  // extern "C"
