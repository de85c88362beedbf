// BASELINE, not on any path of dspnet_torch: the colour kernel
// (ycc_to_bgr_kernel of dspnet_torch/csrc/jpeg.cu) as it stood before it
// took every sampling geometry: one thread per chroma sample writing its 1x1,
// 2x1 or 2x2 output pixels, the first component at full size. chip_smoke.py
// builds it beside dspnet_torch/csrc/jpeg.cu and times both on the same
// 4:2:0 planes in the same run (its entry point is bound there). The notes
// below are the kernel's own.

#include <cuda_runtime.h>

namespace {

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

const char* dspnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
