// JPEG decode on the card through nvJPEG, and libjpeg's chroma upsampling
// and colour conversion as a kernel of this file; plain C interface.
//
// The counterpart of the JAX package's host decode, cv2.imdecode on libjpeg
// (dspnet_tpu/data/iterator.py:73,76; dspnet_tpu/detect/detector.py:210,336),
// for the loader's and the demo's images: JPEG decoding is not a TPU kernel,
// and the CUDA toolkit's libnvjpeg is to the card what libjpeg is to the
// host. nvJPEG decodes each image to its planar Y, Cb and Cr components at
// the stream's own subsampling (NVJPEG_OUTPUT_YUV), in a batch
// (nvjpegDecodeBatched) or one image at a time (nvjpegDecode, for a
// progressive file); then ycc_to_bgr_kernel below does what libjpeg-turbo
// does after its IDCT and nvJPEG does not: the upsampling of jdsample.c as
// jinit_upsampler picks it (the "fancy" triangular h2v1 with biases 1 and
// 2, h2v2 with the 3 * near + far column sums and biases 8 and 7, h1v2 with
// biases 1 and 2 for 4:4:0, edges replicated; a plane at most 2 samples wide
// at h2v1 / h2v2, and every other integral factor up to 4 (4:1:1 among
// them), replicated instead) and the fixed-point YCbCr -> RGB of
// jdcolor.c, writing BGR interleaved into the torch buffer the wrapper
// (dspnet_torch/data/jpeg_cuda.py) allocated. Its other modes take
// nvJPEG's unchanged planes (NVJPEG_OUTPUT_UNCHANGED, the single-image
// call) of a file coded otherwise: RGB (Adobe transform 0: upsampled, only
// reordered), CMYK (cv2's CMYK -> BGR rule) and YCCK (libjpeg's
// ycck_cmyk_convert, then that rule). A lossless file's samples,
// reconstructed on the host, come through the same kernel with every
// factor replicated (libjpeg upsamples no lossless file fancily). nvJPEG's
// own interleaved output (NVJPEG_OUTPUT_BGRI) replicates each chroma
// sample; the wrapper keeps it only as a timed comparison.
//
// The encoder (the counterpart of cv2.imencode / cv2.VideoWriter's JPEG on
// the host): nvjpegEncodeImage from interleaved BGR on the card, baseline
// JFIF at the caller's quality and chroma subsampling with the standard
// Huffman tables, the bitstream copied back to the host.
//
// What bounds the kernel: bytes. It reads the planes once (1.5 H W bytes at
// 4:2:0, through L1 for the 3x3 neighbourhoods) and writes 3 H W bytes: 9.4
// MB at 1024x2048, about 2.8 us at 3.35 TB/s. Each output pixel upsamples
// each component to it by the component's own factors (so any geometry
// libjpeg reads, the first component subsampled too), reading the few
// neighbours it needs through L1, a few integer operations a plane. The
// common geometries (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1) are compiled apart,
// their factors known, and a thread converts the pixels over a chroma
// sample where the fancy upsampling shares work among them; the rest takes
// a run-time path, a pixel a thread. A simple kernel: the writes are 3
// bytes a pixel, not 16-byte vectors.
//
// What bounds nvJPEG: on the default backend the Huffman stage runs on the
// host (one thread per call here), then dequantisation and IDCT run as
// nvJPEG's kernels; on NVJPEG_BACKEND_HARDWARE the card's JPEG engines
// would decode, but nvJPEG refuses that backend ("architecture mismatch")
// on the H100 chip_smoke.py measures, so the default backend is the one used
// (PERF.md).
//
// Threads: one nvjpegHandle_t per (device, backend) may be shared; a
// decoding thread holds an nvjpegJpegState_t of its own for each call (the
// wrapper lends them from a pool). Error codes: CUDA errors as themselves,
// nvJPEG statuses as 1000 + status (dspnet_cuda_error_string names both).

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstddef>
#include <vector>

namespace {

constexpr int kNvjpegBase = 1000;

int status(nvjpegStatus_t s) { return s == NVJPEG_STATUS_SUCCESS ? 0 : kNvjpegBase + static_cast<int>(s); }

const char* nvjpeg_status_name(int s) {
  switch (s) {
    case 1: return "nvJPEG: not initialized";
    case 2: return "nvJPEG: invalid parameter";
    case 3: return "nvJPEG: bad JPEG";
    case 4: return "nvJPEG: JPEG not supported";
    case 5: return "nvJPEG: allocator failure";
    case 6: return "nvJPEG: execution failed";
    case 7: return "nvJPEG: architecture mismatch (backend not available on this card)";
    case 8: return "nvJPEG: internal error";
    case 9: return "nvJPEG: implementation not supported";
    case 10: return "nvJPEG: incomplete bitstream";
    default: return "nvJPEG: unknown status";
  }
}

// The colour kernel's modes: how the components are coded
// (dspnet_torch/data/jpeg_cuda.py::MODES).
constexpr int kYcc = 0, kGray = 1, kRgb = 2, kCmyk = 3, kYcck = 4;

// jdcolor.c's fixed-point tables (16 fraction bits), as formulas:
// FIX(1.40200) = 91881, FIX(1.77200) = 116130, FIX(0.71414) = 46802,
// FIX(0.34414) = 22554 (FIX(x) = (int)(x * 65536 + 0.5)). r, g, b come back
// before the range limit.
__device__ __forceinline__ void ycc_rgb(int y, int cb, int cr, int& r, int& g, int& b) {
  cb -= 128;
  cr -= 128;
  r = y + ((91881 * cr + 32768) >> 16);
  g = y + ((-22554 * cb + 32768 - 46802 * cr) >> 16);
  b = y + ((116130 * cb + 32768) >> 16);
}

__device__ __forceinline__ int clamp255(int v) { return min(max(v, 0), 255); }

// cv2 5.0.0's CMYK -> BGR after libjpeg's CMYK output (icvCvt_CMYK2BGR):
// each of C, M, Y becomes k - ((255 - v) * k >> 8), stored as R, G, B.
__device__ __forceinline__ int cmyk_channel(int v, int k) { return k - (((255 - v) * k) >> 8); }

// One output pixel from its (upsampled) component samples a, b, c, k in the
// file's coding: YCbCr (jdcolor.c's ycc_rgb_convert), RGB (reordered only),
// CMYK (cv2's rule) or YCCK (libjpeg's ycck_cmyk_convert: 255 - the YCbCr
// colour, range-limited, then cv2's rule).
__device__ __forceinline__ void put(unsigned char* p, int mode, int a, int b, int c, int k) {
  if (mode == kRgb) {
    p[0] = static_cast<unsigned char>(c);
    p[1] = static_cast<unsigned char>(b);
    p[2] = static_cast<unsigned char>(a);
    return;
  }
  int r, g, bl;
  if (mode == kCmyk) {
    r = a;
    g = b;
    bl = c;
  } else {
    ycc_rgb(a, b, c, r, g, bl);
    if (mode == kYcc) {
      p[0] = static_cast<unsigned char>(clamp255(bl));
      p[1] = static_cast<unsigned char>(clamp255(g));
      p[2] = static_cast<unsigned char>(clamp255(r));
      return;
    }
    r = clamp255(255 - r);  // YCCK -> CMYK
    g = clamp255(255 - g);
    bl = clamp255(255 - bl);
  }
  p[0] = static_cast<unsigned char>(cmyk_channel(bl, k));
  p[1] = static_cast<unsigned char>(cmyk_channel(g, k));
  p[2] = static_cast<unsigned char>(cmyk_channel(r, k));
}

// The largest upsampling factor (libjpeg's MAX_SAMP_FACTOR).
constexpr int kMaxF = 4;

// One component plane: its samples (h x w, row pitch `pitch`), its
// upsampling factors to the image (fh, fv), each 1..kMaxF, and their log2
// (hs, vs; unused for 3) so that the sample under an output pixel costs a
// shift and not a division.
struct Plane {
  const unsigned char* p;
  int pitch, h, w, fh, fv, hs, vs;
};

__device__ __forceinline__ int down(int x, int f, int shift) { return f == 3 ? x / 3 : x >> shift; }

// Plane q's value at output pixel (ox, oy), upsampled as jinit_upsampler
// picks the method: with `fancy`, h2v1 and h2v2 fancy on a plane wider than
// 2 samples and h1v2 fancy; every other factor (and every factor without
// `fancy`: a lossless file) replicates the sample (h2v1_upsample,
// h2v2_upsample, int_upsample). Edges replicated. FH and FV are the
// plane's factors where the launch knows them, so that the compiler drops
// the other methods; 0 reads them from q.
template <int FH, int FV>
__device__ __forceinline__ int sample(const Plane& q, int ox, int oy, bool fancy) {
  const int fh = FH ? FH : q.fh, fv = FV ? FV : q.fv;
  int cx = FH ? ox / (FH ? FH : 1) : down(ox, fh, q.hs), cy = FV ? oy / (FV ? FV : 1) : down(oy, fv, q.vs);
  const unsigned char* row = q.p + static_cast<size_t>(cy) * q.pitch;
  int c = row[cx];
  if (!fancy || (fh == 1 && fv == 1)) return c;
  if (fh == 1 && fv == 2) {  // h1v2_fancy_upsample: 3/4 this row + 1/4 the nearer other, biases 1 and 2
    int lower = oy & 1;
    int other = q.p[static_cast<size_t>(lower ? min(cy + 1, q.h - 1) : max(cy - 1, 0)) * q.pitch + cx];
    return (3 * c + other + 1 + lower) >> 2;
  }
  if (fh != 2 || fv > 2 || q.w <= 2) return c;
  int right = ox & 1;
  int xn = right ? min(cx + 1, q.w - 1) : max(cx - 1, 0);
  if (fv == 1) return (3 * c + row[xn] + 1 + right) >> 2;  // h2v1_fancy_upsample: biases 1 and 2
  // h2v2_fancy_upsample: column sums 3 * this row + the nearer other row
  // (above for the upper output row, below for the lower one), then 3 * this
  // column sum + the nearer column's, biases 8 and 7
  const unsigned char* other = q.p + static_cast<size_t>((oy & 1) ? min(cy + 1, q.h - 1) : max(cy - 1, 0)) * q.pitch;
  int col = 3 * c + other[cx];
  int ncol = 3 * row[xn] + other[xn];
  return (3 * col + ncol + 8 - right) >> 4;
}

// The output pixels a thread converts across and down: the 2 pixels over a
// chroma sample where the launch knows that factor is 2 (the compiler then
// shares the sample's loads and column sums between them, as libjpeg's
// fancy upsamplers do), else 1 (replication shares nothing worth the
// threads it would take away: 4:1:1 measured faster so).
__host__ __device__ constexpr int pixels(int f) { return f == 2 ? 2 : 1; }

// A thread converts pixels(CH) x pixels(CV) output pixels when the launch
// knows the chroma's factors (CH, CV), with the first component at full
// size; with (0, 0), one pixel, every plane's factors read at run time (any
// geometry). Each pixel: every component upsampled to it by its own factors
// (y, cb, cr; k for CMYK / YCCK), then the pixel in the file's coding.
template <int CH, int CV>
__global__ void ycc_to_bgr_kernel(Plane y, Plane cb, Plane cr, Plane kp, int H, int W, int mode, int fancy,
                                  unsigned char* __restrict__ out) {
  constexpr int YH = CH ? 1 : 0, YV = CV ? 1 : 0, PH = pixels(CH), PV = pixels(CV);
  int ox0 = (blockIdx.x * blockDim.x + threadIdx.x) * PH;
  int oy0 = (blockIdx.y * blockDim.y + threadIdx.y) * PV;
  if (ox0 >= W || oy0 >= H) return;
  bool four = mode == kCmyk || mode == kYcck;
#pragma unroll
  for (int r = 0; r < PV; ++r) {
    int oy = oy0 + r;
    if (oy >= H) break;
    unsigned char* p = out + (static_cast<size_t>(oy) * W + ox0) * 3;
#pragma unroll
    for (int j = 0; j < PH; ++j, p += 3) {
      int ox = ox0 + j;
      if (ox >= W) break;
      int a = sample<YH, YV>(y, ox, oy, fancy);
      if (mode == kGray) {
        p[0] = p[1] = p[2] = static_cast<unsigned char>(a);
        continue;
      }
      int k = four ? sample<0, 0>(kp, ox, oy, fancy) : 0;
      put(p, mode, a, sample<CH, CV>(cb, ox, oy, fancy), sample<CH, CV>(cr, ox, oy, fancy), k);
    }
  }
}

template <int CH, int CV>
void launch(const Plane* q, int H, int W, int mode, int fancy, unsigned char* out, cudaStream_t stream) {
  constexpr int PH = pixels(CH), PV = pixels(CV);
  dim3 block(32, 8);
  dim3 grid((W + block.x * PH - 1) / (block.x * PH), (H + block.y * PV - 1) / (block.y * PV));
  ycc_to_bgr_kernel<CH, CV><<<grid, block, 0, stream>>>(q[0], q[1], q[2], q[3], H, W, mode, fancy, out);
}

}  // namespace

extern "C" {

// A handle for `backend` (an nvjpegBackend_t value) on the current device.
int dspnet_jpeg_create(int backend, void** handle) {
  nvjpegHandle_t h = nullptr;
  int err = status(nvjpegCreateEx(static_cast<nvjpegBackend_t>(backend), nullptr, nullptr, 0, &h));
  *handle = h;
  return err;
}

int dspnet_jpeg_destroy(void* handle) { return status(nvjpegDestroy(static_cast<nvjpegHandle_t>(handle))); }

int dspnet_jpeg_state_create(void* handle, void** state) {
  nvjpegJpegState_t s = nullptr;
  int err = status(nvjpegJpegStateCreate(static_cast<nvjpegHandle_t>(handle), &s));
  *state = s;
  return err;
}

int dspnet_jpeg_state_destroy(void* state) {
  return status(nvjpegJpegStateDestroy(static_cast<nvjpegJpegState_t>(state)));
}

// out[0] = components, out[1] = chroma subsampling
// (nvjpegChromaSubsampling_t), out[2 + c] = height and out[6 + c] = width of
// component c (c < 4).
int dspnet_jpeg_info(void* handle, const unsigned char* data, size_t length, int* out) {
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  nvjpegChromaSubsampling_t css;
  int err = status(nvjpegGetImageInfo(static_cast<nvjpegHandle_t>(handle), data, length, &out[0], &css,
                                      widths, heights));
  out[1] = static_cast<int>(css);
  for (int c = 0; c < 4; ++c) {
    out[2 + c] = heights[c];
    out[6 + c] = widths[c];
  }
  return err;
}

// *supported = 1 when the handle's backend decodes this stream in a batch
// (nvjpegDecodeBatchedSupported reports 0 for "supported").
int dspnet_jpeg_batched_supported(void* handle, const unsigned char* data, size_t length, int* supported) {
  auto h = static_cast<nvjpegHandle_t>(handle);
  nvjpegJpegStream_t stream = nullptr;
  int err = status(nvjpegJpegStreamCreate(h, &stream));
  if (err) return err;
  int flag = 1;
  err = status(nvjpegJpegStreamParse(h, data, length, 0, 0, stream));
  if (!err) err = status(nvjpegDecodeBatchedSupported(h, stream, &flag));
  *supported = flag == 0;
  int err2 = status(nvjpegJpegStreamDestroy(stream));
  return err ? err : err2;
}

// Size the state for batches of `batch` images in `output_format` (an
// nvjpegOutputFormat_t: NVJPEG_OUTPUT_YUV for the planes, NVJPEG_OUTPUT_BGRI
// for nvJPEG's own interleaved pixels).
int dspnet_jpeg_batched_init(void* handle, void* state, int batch, int max_cpu_threads, int output_format) {
  return status(nvjpegDecodeBatchedInitialize(static_cast<nvjpegHandle_t>(handle),
                                              static_cast<nvjpegJpegState_t>(state), batch, max_cpu_threads,
                                              static_cast<nvjpegOutputFormat_t>(output_format)));
}

static void fill_image(nvjpegImage_t* dst, unsigned char* const* outs, const size_t* pitches, int n) {
  for (int c = 0; c < NVJPEG_MAX_COMPONENT; ++c) {
    dst->channel[c] = c < n ? outs[c] : nullptr;
    dst->pitch[c] = c < n ? pitches[c] : 0;
  }
}

// Decode `batch` streams (host memory) in the state's output format on
// `stream`: image i into outs[3 i + c] (device memory, pitch pitches[3 i +
// c] bytes per row) for its channels c < 3 (the interleaved format uses
// channel 0 alone; the others may be null).
int dspnet_jpeg_decode_batched(void* handle, void* state, int batch, const unsigned char* const* data,
                               const size_t* lengths, unsigned char* const* outs, const size_t* pitches,
                               void* stream) {
  std::vector<nvjpegImage_t> dst(batch);
  for (int i = 0; i < batch; ++i) fill_image(&dst[i], outs + 3 * i, pitches + 3 * i, 3);
  int err = status(nvjpegDecodeBatched(static_cast<nvjpegHandle_t>(handle),
                                       static_cast<nvjpegJpegState_t>(state), data, lengths, dst.data(),
                                       static_cast<cudaStream_t>(stream)));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// Decode one stream with nvJPEG's single-image call (nvjpegDecode, which
// takes progressive files) into outs[c] / pitches[c], c < 4 (NVJPEG_OUTPUT_UNCHANGED
// writes a fourth component there; the other formats three), in
// `output_format`, on `stream`.
int dspnet_jpeg_decode_single(void* handle, void* state, const unsigned char* data, size_t length,
                              int output_format, unsigned char* const* outs, const size_t* pitches,
                              void* stream) {
  nvjpegImage_t dst;
  fill_image(&dst, outs, pitches, NVJPEG_MAX_COMPONENT);
  int err = status(nvjpegDecode(static_cast<nvjpegHandle_t>(handle), static_cast<nvjpegJpegState_t>(state),
                                data, length, static_cast<nvjpegOutputFormat_t>(output_format), &dst,
                                static_cast<cudaStream_t>(stream)));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// libjpeg-turbo's upsampling + colour conversion on one image's planes (see
// the file's head): `n` planes (1 for kGray, 3, or 4 for kCmyk / kYcck),
// plane i at planes[i] with geometry[5 i ..] = (pitch, h, w, fh, fv): its
// rows, its size and its upsampling factors to the H x W image (each
// 1..4); `mode` one of kYcc, kGray, kRgb, kCmyk, kYcck; `fancy` 0
// replicates at every factor (a lossless file). Writes out (H x W x 3, BGR,
// contiguous) on `stream`.
int dspnet_jpeg_ycc_to_bgr(const unsigned char* const* planes, const int* geometry, int n, int H, int W, int mode,
                           int fancy, unsigned char* out, void* stream) {
  int want = mode == kGray ? 1 : (mode == kCmyk || mode == kYcck) ? 4 : 3;
  if (n != want || H <= 0 || W <= 0 || mode < kYcc || mode > kYcck) return static_cast<int>(cudaErrorInvalidValue);
  Plane q[4];
  for (int i = 0; i < 4; ++i) {
    const int* g = geometry + 5 * (i < n ? i : 0);
    q[i] = Plane{planes[i < n ? i : 0], g[0], g[1], g[2], g[3], g[4], g[3] / 2, g[4] / 2};
    if (q[i].fh < 1 || q[i].fh > kMaxF || q[i].fv < 1 || q[i].fv > kMaxF || q[i].h * q[i].fv < H ||
        q[i].w * q[i].fh < W || q[i].pitch < q[i].w)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  // the common geometries (the first component at full size, Cb and Cr at
  // one factor) compiled apart; any other through the run-time path
  bool common = n >= 3 && q[0].fh == 1 && q[0].fv == 1 && q[1].fh == q[2].fh && q[1].fv == q[2].fv;
  int f = common ? q[1].fh * 10 + q[1].fv : 0;
  if (f == 11) launch<1, 1>(q, H, W, mode, fancy, out, s);
  else if (f == 21) launch<2, 1>(q, H, W, mode, fancy, out, s);
  else if (f == 22) launch<2, 2>(q, H, W, mode, fancy, out, s);
  else if (f == 12) launch<1, 2>(q, H, W, mode, fancy, out, s);
  else if (f == 41) launch<4, 1>(q, H, W, mode, fancy, out, s);
  else launch<0, 0>(q, H, W, mode, fancy, out, s);
  return static_cast<int>(cudaGetLastError());
}

// ---- the encoder: nvJPEG's baseline JFIF from interleaved BGR on the card

// An encoder state and parameters for the handle's device: `quality`
// (1..100), chroma subsampling `css` (an nvjpegChromaSubsampling_t:
// NVJPEG_CSS_420 for cv2's default), baseline Huffman coding with the
// standard tables.
int dspnet_jpeg_encoder_create(void* handle, int quality, int css, void** state, void** params, void* stream) {
  auto h = static_cast<nvjpegHandle_t>(handle);
  auto s = static_cast<cudaStream_t>(stream);
  nvjpegEncoderState_t st = nullptr;
  nvjpegEncoderParams_t pr = nullptr;
  int err = status(nvjpegEncoderStateCreate(h, &st, s));
  if (!err) err = status(nvjpegEncoderParamsCreate(h, &pr, s));
  if (!err) err = status(nvjpegEncoderParamsSetQuality(pr, quality, s));
  if (!err) err = status(nvjpegEncoderParamsSetSamplingFactors(pr, static_cast<nvjpegChromaSubsampling_t>(css), s));
  if (!err) err = status(nvjpegEncoderParamsSetEncoding(pr, NVJPEG_ENCODING_BASELINE_DCT, s));
  if (!err) err = status(nvjpegEncoderParamsSetOptimizedHuffman(pr, 0, s));
  *state = st;
  *params = pr;
  return err;
}

int dspnet_jpeg_encoder_destroy(void* state, void* params) {
  int err = status(nvjpegEncoderParamsDestroy(static_cast<nvjpegEncoderParams_t>(params)));
  int err2 = status(nvjpegEncoderStateDestroy(static_cast<nvjpegEncoderState_t>(state)));
  return err ? err : err2;
}

// Encode an H x W interleaved BGR image (device memory, `pitch` bytes a
// row) on `stream`, then wait for it and give the bitstream's length in
// *length.
int dspnet_jpeg_encode_bgr(void* handle, void* state, void* params, const unsigned char* bgr, size_t pitch, int H,
                           int W, size_t* length, void* stream) {
  auto h = static_cast<nvjpegHandle_t>(handle);
  auto st = static_cast<nvjpegEncoderState_t>(state);
  auto s = static_cast<cudaStream_t>(stream);
  nvjpegImage_t src;
  for (int c = 0; c < NVJPEG_MAX_COMPONENT; ++c) {
    src.channel[c] = nullptr;
    src.pitch[c] = 0;
  }
  src.channel[0] = const_cast<unsigned char*>(bgr);
  src.pitch[0] = pitch;
  int err = status(nvjpegEncodeImage(h, st, static_cast<nvjpegEncoderParams_t>(params), &src, NVJPEG_INPUT_BGRI, W,
                                     H, s));
  if (!err) err = status(nvjpegEncodeRetrieveBitstream(h, st, nullptr, length, s));
  if (!err) err = static_cast<int>(cudaStreamSynchronize(s));
  return err;
}

// Copy the last encode's bitstream (*length bytes, from
// dspnet_jpeg_encode_bgr) into host memory `data`.
int dspnet_jpeg_encode_retrieve(void* handle, void* state, unsigned char* data, size_t* length, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  int err = status(nvjpegEncodeRetrieveBitstream(static_cast<nvjpegHandle_t>(handle),
                                                 static_cast<nvjpegEncoderState_t>(state), data, length, s));
  if (!err) err = static_cast<int>(cudaStreamSynchronize(s));
  return err;
}

const char* dspnet_cuda_error_string(int err) {
  if (err >= kNvjpegBase) return nvjpeg_status_name(err - kNvjpegBase);
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
