// BASELINE, not on any path of dspnet_torch: the NMS kernel as it stood
// before its redesign for Hopper (a bitmask launch, then a per-image scan
// whose 400 rows are one dependent chain of one warp). chip_smoke.py builds
// it beside dspnet_torch/csrc/nms.cu and times both on the same inputs in
// the same run, so that the redesign is judged against it there (its entry
// point is bound there). The note below is the kernel's own.
//
// Greedy class-aware NMS keep mask for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel dspnet_tpu/ops/nms_pallas.py::_nms_kernel, which
// builds a dense K x K f32 suppression matrix in VMEM and iterates the
// fixpoint keep = valid & ~(keep @ S) on the MXU. That shape exists for the
// TPU's matrix unit; here the same mask comes from the bitmask scheme of the
// reference's gpu_nms (Faster R-CNN style), with this repo's IoU (no +1):
//
//   launch 1 (nms_mask_kernel): grid (ceil(K/64), ceil(K/64), B), 64 threads.
//     Thread i of tile (row_tile, col_tile) writes the uint64 word
//     mask[b, i, col_tile] whose bit t says row i suppresses row
//     j = 64 * col_tile + t:  j > i, both valid, same class (unless
//     force_suppress) and iou(i, j) >= thr.
//   launch 2 (nms_scan_kernel): one block per image walks i = 0..K-1 in
//     order with a `removed` bitset in shared memory; row i is kept when it is
//     valid and not removed, and then ORs its mask row into `removed`. This is
//     the sequential greedy, which the TPU kernel's fixpoint equals.
//
// What bounds it on the card: not bytes or FLOPs (at K = 400 the mask is
// 22 KB per image and the IoU work 80k pairs) but the scan's dependence
// chain, K steps of a shared-memory read, a branch and an OR. The design
// keeps every step of that chain in shared memory: the block stages chunks of
// mask rows (the whole image at K = 400) with all its threads in coalesced
// loads, and one warp then walks the staged rows with no global-memory
// latency inside the chain. Images run in parallel, one block each.
//
// Exactness: the IoU is computed in the JAX order with round-to-nearest
// intrinsics, so nvcc cannot contract (area_i + area_j) - iw * ih into an FMA
// and the division is IEEE; `iou >= thr` then decides exactly as the f32
// reference does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;               // rows / columns per mask word
constexpr int kScanThreads = 256;       // staging threads; warp 0 scans
constexpr int kStageBytes = 40 * 1024;  // shared memory for staged mask rows

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

__device__ __forceinline__ bool iou_at_least(float4 a, float4 b, float thr) {
  const float iw = fmaxf(0.0f, __fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)));
  const float ih = fmaxf(0.0f, __fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)));
  const float inter = __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(area(a), area(b)), inter);
  const float iou = uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
  return iou >= thr;
}

__global__ void nms_mask_kernel(const float4* __restrict__ boxes, const float* __restrict__ ids,
                                const bool* __restrict__ valid, unsigned long long* __restrict__ mask,
                                int K, int words, float thr, int force_suppress) {
  const int col_tile = blockIdx.x;
  const int row_tile = blockIdx.y;
  const size_t base = static_cast<size_t>(blockIdx.z) * K;
  const int j0 = col_tile * kTile;
  const int ncols = min(kTile, K - j0);

  __shared__ float4 col_box[kTile];
  __shared__ float col_id[kTile];
  __shared__ bool col_valid[kTile];
  if (threadIdx.x < ncols) {
    col_box[threadIdx.x] = boxes[base + j0 + threadIdx.x];
    col_id[threadIdx.x] = ids[base + j0 + threadIdx.x];
    col_valid[threadIdx.x] = valid[base + j0 + threadIdx.x];
  }
  __syncthreads();

  const int i = row_tile * kTile + threadIdx.x;
  if (i >= K) return;
  unsigned long long bits = 0;
  // tiles left of the diagonal hold no j > i: their words stay zero
  if (col_tile >= row_tile && valid[base + i]) {
    const float4 box = boxes[base + i];
    const float id = ids[base + i];
    const int start = col_tile == row_tile ? threadIdx.x + 1 : 0;
    for (int t = start; t < ncols; ++t) {
      if (col_valid[t] && (force_suppress || col_id[t] == id) && iou_at_least(box, col_box[t], thr)) {
        bits |= 1ull << t;
      }
    }
  }
  mask[(base + i) * words + col_tile] = bits;
}

__global__ void nms_scan_kernel(const unsigned long long* __restrict__ mask,
                                const bool* __restrict__ valid, bool* __restrict__ keep,
                                int K, int words, int rows_per_stage) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* removed = smem;              // [words]
  unsigned long long* stage = smem + words;        // [rows_per_stage * words]
  bool* stage_valid = reinterpret_cast<bool*>(stage + static_cast<size_t>(rows_per_stage) * words);

  const size_t base = static_cast<size_t>(blockIdx.x) * K;
  const unsigned long long* image_mask = mask + base * words;
  const int lane = threadIdx.x;  // meaningful in warp 0 only

  for (int w = threadIdx.x; w < words; w += blockDim.x) removed[w] = 0;

  for (int r0 = 0; r0 < K; r0 += rows_per_stage) {
    const int nr = min(rows_per_stage, K - r0);
    __syncthreads();  // the previous chunk's scan is done with `stage`
    const size_t n = static_cast<size_t>(nr) * words;
    for (size_t x = threadIdx.x; x < n; x += blockDim.x) {
      stage[x] = image_mask[static_cast<size_t>(r0) * words + x];
    }
    for (int r = threadIdx.x; r < nr; r += blockDim.x) stage_valid[r] = valid[base + r0 + r];
    __syncthreads();
    if (threadIdx.x < 32) {
      for (int r = 0; r < nr; ++r) {
        const int i = r0 + r;
        const int w = i >> 6;
        // every lane reads the same word, so `kept` is warp-uniform
        const bool kept = stage_valid[r] && !((removed[w] >> (i & 63)) & 1ull);
        if (kept) {
          const unsigned long long* row = stage + static_cast<size_t>(r) * words;
          for (int x = w + lane; x < words; x += 32) removed[x] |= row[x];
        }
        if (lane == 0) keep[base + i] = kept;
        __syncwarp();
      }
    }
  }
}

// Shared memory the scan needs for K rows of `words` mask words.
void scan_layout(int K, int words, int* rows_per_stage, size_t* smem_bytes) {
  const int budget_words = kStageBytes / 8;
  int rows = budget_words / words;
  rows = rows < 1 ? 1 : (rows > K ? K : rows);
  *rows_per_stage = rows;
  *smem_bytes = (static_cast<size_t>(words) + static_cast<size_t>(rows) * words) * 8 + rows;
}

}  // namespace

extern "C" {

// boxes (B, K, 4) f32, ids (B, K) f32, valid (B, K) bool, all contiguous on
// the current device; mask (B, K, ceil(K/64)) uint64 scratch; keep (B, K)
// bool out. Launches on `stream` and returns cudaGetLastError().
int dspnet_nms_keep_mask(const void* boxes, const void* ids, const void* valid, void* mask,
                         void* keep, int B, int K, float thr, int force_suppress, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = (K + kTile - 1) / kTile;
  dim3 grid(words, words, B);
  nms_mask_kernel<<<grid, kTile, 0, s>>>(static_cast<const float4*>(boxes),
                                         static_cast<const float*>(ids),
                                         static_cast<const bool*>(valid),
                                         static_cast<unsigned long long*>(mask), K, words, thr,
                                         force_suppress);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  int rows;
  size_t smem;
  scan_layout(K, words, &rows, &smem);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  nms_scan_kernel<<<B, kScanThreads, smem, s>>>(static_cast<const unsigned long long*>(mask),
                                                static_cast<const bool*>(valid),
                                                static_cast<bool*>(keep), K, words, rows);
  return cudaGetLastError();
}

const char* dspnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
