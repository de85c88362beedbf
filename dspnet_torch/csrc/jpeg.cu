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
// does after its IDCT and nvJPEG does not: the "fancy" triangular chroma
// upsampling of jdsample.c (h2v1 with biases 1 and 2, h2v2 with the
// 3 * near + far column sums and biases 8 and 7, edges replicated, a plane
// at most 2 samples wide replicated instead) and the fixed-point YCbCr ->
// RGB of jdcolor.c, writing BGR interleaved into the torch buffer the
// wrapper (dspnet_torch/data/jpeg_cuda.py) allocated. Its other modes take
// nvJPEG's unchanged planes (NVJPEG_OUTPUT_UNCHANGED, the single-image
// call) of a file coded otherwise: RGB (Adobe transform 0: upsampled, only
// reordered), CMYK (cv2's CMYK -> BGR rule) and YCCK (libjpeg's
// ycck_cmyk_convert, then that rule). nvJPEG's own interleaved output
// (NVJPEG_OUTPUT_BGRI) replicates each chroma sample; the wrapper keeps it
// only as a timed comparison.
//
// The encoder (the counterpart of cv2.imencode / cv2.VideoWriter's JPEG on
// the host): nvjpegEncodeImage from interleaved BGR on the card, baseline
// JFIF at the caller's quality and chroma subsampling with the standard
// Huffman tables, the bitstream copied back to the host.
//
// What bounds the kernel: bytes. It reads the planes once (1.5 H W bytes at
// 4:2:0, through L1 for the 3x3 neighbourhoods) and writes 3 H W bytes: 9.4
// MB at 1024x2048, about 2.8 us at 3.35 TB/s. One thread per chroma sample
// writes its 2x1 or 2x2 output pixels, so each neighbourhood is read once per
// thread and the arithmetic is a few integer operations a pixel. A simple
// kernel: the writes are 6 bytes a thread, not 16-byte vectors.
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

// The (up to) 2x2 upsampled values of chroma sample (cx, cy) of plane p:
// o[row][column] for output rows cy * fv + row and columns 2 cx + column.
__device__ __forceinline__ void fancy(const unsigned char* p, int pitch, int cx, int cy, int cw, int ch, int fv,
                                      int o[2][2]) {
  const unsigned char* row = p + static_cast<size_t>(cy) * pitch;
  int c = row[cx];
  if (cw <= 2) {  // libjpeg-turbo replicates a component this narrow
    o[0][0] = o[0][1] = o[1][0] = o[1][1] = c;
    return;
  }
  int xl = max(cx - 1, 0), xr = min(cx + 1, cw - 1);
  if (fv == 1) {  // h2v1_fancy_upsample
    o[0][0] = (3 * c + row[xl] + 1) >> 2;
    o[0][1] = (3 * c + row[xr] + 2) >> 2;
    return;
  }
  // h2v2_fancy_upsample: column sums 3 * this row + the nearer other row
  // (the row above for the upper output row, below for the lower one; edges
  // replicated), then 3 * this column sum + the neighbour's
  for (int k = 0; k < 2; ++k) {
    const unsigned char* other = p + static_cast<size_t>(k == 0 ? max(cy - 1, 0) : min(cy + 1, ch - 1)) * pitch;
    int col = 3 * c + other[cx];
    int left = 3 * row[xl] + other[xl];
    int right = 3 * row[xr] + other[xr];
    o[k][0] = (3 * col + left + 8) >> 4;
    o[k][1] = (3 * col + right + 7) >> 4;
  }
}

// One thread per chroma sample (per pixel at 4:4:4 and for gray): its fh x
// fv output pixels inside the H x W image. Planes: y (the first component,
// full size), cb and cr (the second and third, ch x cw at factors (fh, fv)),
// k (the fourth, for CMYK / YCCK: full size when k_full, else at the
// chroma's factors and pitch k_pitch).
__global__ void ycc_to_bgr_kernel(const unsigned char* __restrict__ y, int y_pitch,
                                  const unsigned char* __restrict__ cb, const unsigned char* __restrict__ cr,
                                  int c_pitch, const unsigned char* __restrict__ kp, int k_pitch, int k_full,
                                  int H, int W, int ch, int cw, int fh, int fv, int mode,
                                  unsigned char* __restrict__ out) {
  int cx = blockIdx.x * blockDim.x + threadIdx.x;
  int cy = blockIdx.y * blockDim.y + threadIdx.y;
  if (cx >= cw || cy >= ch) return;
  if (mode == kGray) {
    unsigned char v = y[static_cast<size_t>(cy) * y_pitch + cx];
    unsigned char* p = out + (static_cast<size_t>(cy) * W + cx) * 3;
    p[0] = p[1] = p[2] = v;
    return;
  }
  bool four = mode == kCmyk || mode == kYcck;
  if (fh == 1 && fv == 1) {
    size_t c = static_cast<size_t>(cy) * c_pitch + cx;
    int k = four ? kp[static_cast<size_t>(cy) * k_pitch + cx] : 0;
    put(out + (static_cast<size_t>(cy) * W + cx) * 3, mode, y[static_cast<size_t>(cy) * y_pitch + cx], cb[c], cr[c],
        k);
    return;
  }
  int ub[2][2], ur[2][2], uk[2][2];
  fancy(cb, c_pitch, cx, cy, cw, ch, fv, ub);
  fancy(cr, c_pitch, cx, cy, cw, ch, fv, ur);
  if (four && !k_full) fancy(kp, k_pitch, cx, cy, cw, ch, fv, uk);
  for (int r = 0; r < fv; ++r) {
    int oy = cy * fv + r;
    if (oy >= H) break;
    for (int k = 0; k < 2; ++k) {
      int ox = cx * 2 + k;
      if (ox >= W) break;
      int kv = !four ? 0 : k_full ? kp[static_cast<size_t>(oy) * k_pitch + ox] : uk[r][k];
      put(out + (static_cast<size_t>(oy) * W + ox) * 3, mode, y[static_cast<size_t>(oy) * y_pitch + ox], ub[r][k],
          ur[r][k], kv);
    }
  }
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
// the file's head): y (H x W, pitch y_pitch), cb and cr (ch x cw, the
// component's own cropped size, pitch c_pitch) with chroma factors (fh, fv)
// in {(1, 1), (2, 1), (2, 2)}, k (the fourth component, CMYK / YCCK only:
// H x W when k_full, else ch x cw; pitch k_pitch); `mode` one of kYcc,
// kGray (y alone), kRgb, kCmyk, kYcck. Writes out (H x W x 3, BGR,
// contiguous) on `stream`.
int dspnet_jpeg_ycc_to_bgr(const unsigned char* y, int y_pitch, const unsigned char* cb,
                           const unsigned char* cr, int c_pitch, const unsigned char* k, int k_pitch, int k_full,
                           int H, int W, int ch, int cw, int fh, int fv, int mode, unsigned char* out,
                           void* stream) {
  if (mode == kGray) {
    ch = H;
    cw = W;
  }
  if (ch <= 0 || cw <= 0 || mode < kYcc || mode > kYcck) return static_cast<int>(cudaErrorInvalidValue);
  dim3 block(32, 8);
  dim3 grid((cw + block.x - 1) / block.x, (ch + block.y - 1) / block.y);
  ycc_to_bgr_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(y, y_pitch, cb, cr, c_pitch, k, k_pitch,
                                                                          k_full, H, W, ch, cw, fh, fv, mode, out);
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
