// BASELINE, not on any path of dspnet_torch: the bipartite matcher as it
// stood before its redesign for Hopper (one 512-thread block per image, a
// per-column best-pair cache, rescans of the columns a match took).
// chip_smoke.py builds it beside dspnet_torch/csrc/match.cu and times both
// on the same inputs in the same run, so that the redesign is judged against
// it there (its entry point is bound there). The note below is the
// kernel's own.
//
// Greedy bipartite anchor<->GT matching (phase 1 of MultiBoxTarget) for
// Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel dspnet_tpu/ops/matching_pallas.py::_match_kernel
// (wrapper bipartite_match_pallas). That kernel DMAs the image's whole
// (A, L) IoU matrix into VMEM (12.6 MB at A = 12,264, L padded to 256) and
// rewrites it once per match. Shared memory here is 227 KB, so the matrix
// stays in device memory and is read, never written:
//
//   one block per image keeps in shared memory
//     cache[l]  the best available pair of open column l, packed as the u64
//               key (float_bits(iou) << 32) | (0xFFFFFFFF - anchor): every
//               value that can win is > 1e-6 > 0, so the bits order like the
//               value, and on equal values the smaller anchor has the larger
//               key. 0 means "nothing left" (retired, invalid, or no IoU
//               above 1e-6);
//     used      one bit per retired anchor (1.5 KB at A = 12,264);
//   1. one pass over the valid columns fills the cache: each thread keeps
//      one column's best key in a register over a strided set of rows and
//      merges it with a shared-memory atomicMax;
//   2. each iteration takes the largest key over the <= L cache entries,
//      ties to the smallest column (largest value, then smallest anchor,
//      then smallest column: the smallest row-major index a * L + l among
//      the maxima), stops when it is 0 (max IoU <= 1e-6 or no column open),
//      writes match_gt[a] and match_iou[a], retires a and l, and rescans
//      only the columns whose cached anchor was a: removing any other
//      anchor changes neither their maximum nor its first index.
//
// The kernel only moves values, never computes one, so it agrees bit for
// bit with the plain propose/accept rounds (ops/matching_cuda.py).
//
// What bounds it on the card: one block per image, so B of 132 SMs work and
// each reads its image through one SM's load path. The first pass touches
// only valid columns, a 32-byte sector per row when they are a short prefix
// (8 of 200 in the canonical batch: 0.4 MB per image of the 9.8 MB matrix);
// with every column valid it reads the whole 9.8 MB (A = 12,264, L = 200)
// through one SM. The iteration chain is at most num_gt steps of a block
// reduction plus a rescan of the affected columns (A strided reads each).
// Later work: split the first pass over several blocks per image (a
// cross-block max per column), and compute IoU on the fly from the anchors
// and the GT boxes instead of reading the materialized matrix.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;  // rows in flight per thread in a column scan
constexpr float kMinIou = 1e-6f;

__device__ __forceinline__ u64 make_key(float v, int a) {
  return v > kMinIou ? (static_cast<u64>(__float_as_uint(v)) << 32) |
                           static_cast<u64>(0xFFFFFFFFu - static_cast<unsigned>(a))
                     : 0ull;
}

__device__ __forceinline__ int key_anchor(u64 key) {
  return static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(key & 0xFFFFFFFFull));
}

__device__ __forceinline__ float key_value(u64 key) {
  return __uint_as_float(static_cast<unsigned>(key >> 32));
}

__device__ __forceinline__ bool is_used(const unsigned* used, int a) {
  return (used[a >> 5] >> (a & 31)) & 1u;
}

// Largest key, ties to the smallest column, over the lanes of a warp.
__device__ __forceinline__ void warp_argmax(u64& key, int& col) {
  for (int o = 16; o > 0; o >>= 1) {
    const u64 k = __shfl_down_sync(0xffffffffu, key, o);
    const int c = __shfl_down_sync(0xffffffffu, col, o);
    if (k > key || (k == key && c < col)) {
      key = k;
      col = c;
    }
  }
}

// cache[cols[j]] = max(cache[cols[j]], best available key of column cols[j])
// for j < n. Thread t scans column j = t % nj of a chunk of nj columns over
// rows t / nj, t / nj + rows_per_pass, ...; consecutive threads read
// neighbouring columns of one row.
template <bool kSkipUsed>
__device__ void scan_columns(const float* __restrict__ img, int A, int L, const int* cols, int n,
                             const unsigned* used, u64* cache) {
  for (int j0 = 0; j0 < n; j0 += kThreads) {
    const int nj = min(kThreads, n - j0);
    const int step = kThreads / nj;  // rows per pass
    const int j = threadIdx.x % nj;
    const int r = threadIdx.x / nj;
    if (r >= step) continue;
    const int c = cols[j0 + j];
    const float* col = img + c;
    u64 best = 0ull;
    int a = r;
    for (; a + (kUnroll - 1) * step < A; a += kUnroll * step) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(col + static_cast<size_t>(a + u * step) * L);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int au = a + u * step;
        if (kSkipUsed && is_used(used, au)) continue;
        const u64 k = make_key(v[u], au);
        best = k > best ? k : best;
      }
    }
    for (; a < A; a += step) {
      if (kSkipUsed && is_used(used, a)) continue;
      const u64 k = make_key(__ldg(col + static_cast<size_t>(a) * L), a);
      best = k > best ? k : best;
    }
    if (best) atomicMax(&cache[c], best);
  }
}

__global__ void __launch_bounds__(kThreads)
match_kernel(const float* __restrict__ iou, const bool* __restrict__ col_valid,
             bool* __restrict__ matched, int* __restrict__ match_gt,
             float* __restrict__ match_iou, int A, int L) {
  extern __shared__ u64 smem[];
  u64* cache = smem;                                       // [L]
  int* cols = reinterpret_cast<int*>(cache + L);           // [L] columns to scan
  unsigned* used = reinterpret_cast<unsigned*>(cols + L);  // [ceil(A / 32)]
  __shared__ u64 red_key[kWarps];
  __shared__ int red_col[kWarps];
  __shared__ int s_anchor, s_count, s_done;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t b = blockIdx.x;
  const float* img = iou + b * A * L;
  const bool* valid = col_valid + b * L;
  bool* out_m = matched + b * A;
  int* out_g = match_gt + b * A;
  float* out_v = match_iou + b * A;
  const int words = (A + 31) >> 5;

  for (int a = tid; a < A; a += kThreads) {
    out_m[a] = false;
    out_g[a] = -1;
    out_v[a] = -1.0f;
  }
  for (int w = tid; w < words; w += kThreads) used[w] = 0u;
  for (int l = tid; l < L; l += kThreads) cache[l] = 0ull;
  if (tid == 0) {
    int n = 0;
    for (int l = 0; l < L; ++l)
      if (valid[l]) cols[n++] = l;
    s_count = n;
  }
  __syncthreads();
  scan_columns<false>(img, A, L, cols, s_count, used, cache);
  __syncthreads();

  while (true) {
    u64 key = 0ull;
    int col = L;
    for (int l = tid; l < L; l += kThreads) {  // ascending l: strict > keeps the first
      const u64 k = cache[l];
      if (k > key) {
        key = k;
        col = l;
      }
    }
    warp_argmax(key, col);
    if (lane == 0) {
      red_key[warp] = key;
      red_col[warp] = col;
    }
    __syncthreads();
    if (warp == 0) {
      key = lane < kWarps ? red_key[lane] : 0ull;
      col = lane < kWarps ? red_col[lane] : L;
      warp_argmax(key, col);
      if (lane == 0) {
        s_done = key == 0ull;
        if (key != 0ull) {
          const int a = key_anchor(key);
          out_m[a] = true;
          out_g[a] = col;
          out_v[a] = key_value(key);
          used[a >> 5] |= 1u << (a & 31);
          cache[col] = 0ull;
          s_anchor = a;
        }
        s_count = 0;
      }
    }
    __syncthreads();
    if (s_done) break;
    const int a_won = s_anchor;
    for (int l = tid; l < L; l += kThreads) {
      const u64 k = cache[l];
      if (k != 0ull && key_anchor(k) == a_won) {
        cache[l] = 0ull;
        cols[atomicAdd(&s_count, 1)] = l;
      }
    }
    __syncthreads();
    scan_columns<true>(img, A, L, cols, s_count, used, cache);
    __syncthreads();
  }
}

size_t shared_bytes(int A, int L) {
  return static_cast<size_t>(L) * (sizeof(u64) + sizeof(int)) +
         static_cast<size_t>((A + 31) / 32) * sizeof(unsigned);
}

}  // namespace

extern "C" {

// Dynamic shared memory one image needs; the wrapper checks it against the
// card's limit before it launches.
size_t dspnet_match_shared_bytes(int A, int L) { return shared_bytes(A, L); }

// iou (B, A, L) f32 and col_valid (B, L) bool, contiguous on the current
// device; matched (B, A) bool, match_gt (B, A) int32 and match_iou (B, A)
// f32 out (-1 where unmatched). Launches on `stream` and returns
// cudaGetLastError().
int dspnet_bipartite_match(const void* iou, const void* col_valid, void* matched, void* match_gt,
                           void* match_iou, int B, int A, int L, void* stream) {
  if (B <= 0 || A <= 0) return 0;
  const size_t smem = shared_bytes(A, L);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  match_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(iou), static_cast<const bool*>(col_valid),
      static_cast<bool*>(matched), static_cast<int*>(match_gt), static_cast<float*>(match_iou),
      A, L);
  return cudaGetLastError();
}

const char* dspnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
