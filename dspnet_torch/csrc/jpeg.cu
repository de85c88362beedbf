// Batched JPEG decode on the card through nvJPEG, plain C interface.
//
// The counterpart of the JAX package's host decode, cv2.imdecode on libjpeg
// (dspnet_tpu/data/iterator.py:73,76), for the loader's images: JPEG decoding
// is not a TPU kernel, and the CUDA toolkit's libnvjpeg is to the card what
// libjpeg is to the host. This file holds no kernel of its own: it binds the
// few nvJPEG calls the wrapper (dspnet_torch/data/jpeg_cuda.py) needs, so the
// wrapper can decode B encoded buffers straight into torch-allocated device
// memory, BGR interleaved (NVJPEG_OUTPUT_BGRI), on a caller-given stream.
//
// What bounds it: on the default backend the Huffman stage runs on the host
// (one thread per call here), then dequantisation, IDCT, upsampling and
// colour conversion run as nvJPEG's kernels, which read the coefficients and
// write H x W x 3 bytes per image; on NVJPEG_BACKEND_HARDWARE the card's JPEG
// engines would do the whole decode, but nvJPEG refuses that backend
// ("architecture mismatch") on the H100 chip_smoke.py measures, so the
// default backend is the one used (PERF.md).
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

// out[0..3] = components, chroma subsampling (nvjpegChromaSubsampling_t),
// height and width of the image (its first component).
int dspnet_jpeg_info(void* handle, const unsigned char* data, size_t length, int* out) {
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  nvjpegChromaSubsampling_t css;
  int err = status(nvjpegGetImageInfo(static_cast<nvjpegHandle_t>(handle), data, length, &out[0], &css,
                                      widths, heights));
  out[1] = static_cast<int>(css);
  out[2] = heights[0];
  out[3] = widths[0];
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

// Size the state for batches of `batch` images, BGR interleaved output.
int dspnet_jpeg_batched_init(void* handle, void* state, int batch, int max_cpu_threads) {
  return status(nvjpegDecodeBatchedInitialize(static_cast<nvjpegHandle_t>(handle),
                                              static_cast<nvjpegJpegState_t>(state), batch,
                                              max_cpu_threads, NVJPEG_OUTPUT_BGRI));
}

// Decode `batch` streams (host memory) into outs[i] (device memory, pitch
// pitches[i] bytes per row, height x width x 3 bytes) on `stream`.
int dspnet_jpeg_decode_batched(void* handle, void* state, int batch, const unsigned char* const* data,
                               const size_t* lengths, unsigned char* const* outs, const size_t* pitches,
                               void* stream) {
  std::vector<nvjpegImage_t> dst(batch);
  for (int i = 0; i < batch; ++i) {
    for (int c = 0; c < NVJPEG_MAX_COMPONENT; ++c) {
      dst[i].channel[c] = nullptr;
      dst[i].pitch[c] = 0;
    }
    dst[i].channel[0] = outs[i];
    dst[i].pitch[0] = pitches[i];
  }
  int err = status(nvjpegDecodeBatched(static_cast<nvjpegHandle_t>(handle),
                                       static_cast<nvjpegJpegState_t>(state), data, lengths, dst.data(),
                                       static_cast<cudaStream_t>(stream)));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

const char* dspnet_cuda_error_string(int err) {
  if (err >= kNvjpegBase) return nvjpeg_status_name(err - kNvjpegBase);
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
