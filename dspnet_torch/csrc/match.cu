// Greedy bipartite anchor<->GT matching (phase 1 of MultiBoxTarget) for
// Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel dspnet_tpu/ops/matching_pallas.py::_match_kernel
// (wrapper bipartite_match_pallas). That kernel DMAs the image's whole
// (A, L) IoU matrix into VMEM (12.6 MB at A = 12,264, L padded to 256) and
// rewrites it once per match. Shared memory here is 227 KB, so the matrix
// stays in device memory and is read once, never written.
//
// Keys: a pair (anchor a, IoU v) of a column is the u64
// (float_bits(v) << 32) | (0xFFFFFFFF - a), 0 when v <= 1e-6. Every value
// that can win is > 0, so the bits order like the value, and on equal values
// the smaller anchor has the larger key. The greedy's order over all pairs
// (value descending, then the smallest row-major index a * L + l) is the
// order of the packed key (float_bits(v) << 32) | (0xFFFFFF - a) << 8 |
// (255 - l), for A < 2^24 and L <= 256.
//
// The invariant the design rests on: take column l's keys in descending
// order; its best *available* pair is the first whose anchor is not retired.
// So a column's top-T list holds its answer until all T of its anchors are
// retired, and even then the list's last key bounds what the column has
// left: the column needs device memory again only when that bound beats the
// best head of every other column.
//
//   launch 1, match_topk_kernel, grid (S, B): block (s, b) takes the anchor
//     chunk [A s / S, A (s + 1) / S) of image b, writes its rows of the
//     outputs as unmatched, and the top-T keys of each valid column over the
//     chunk to a (B, S, L, T) u64 scratch. S * B >= 2 x 132, so the pass runs
//     over the whole card. Up to 16 valid columns, whole warps take a column
//     (lanes on neighbouring rows); more, threads take (column, row group)
//     pairs, neighbouring threads on neighbouring columns of a row. A thread
//     keeps a register top-T over its rows, merging batches of T rows sorted
//     by a network while the next batch's loads are in flight; a warp's
//     lanes then give their column's top-T by T rounds of a warp max, and
//     warps or row groups merge through shared memory (bitonic merges).
//   launch 2, match_greedy_kernel, one block per image:
//     1. a warp per column merges the column's S lists into one top-T list
//        in shared memory (lanes over chunks, then T warp max rounds);
//     2. warp 0 runs the greedy. Each lane holds the heads of its columns
//        (j = lane + 32 k, the code specialised for 1, 2, 4 or 8 of them)
//        in registers; a step is two 32-bit warp max reductions over the
//        packed heads and bounds, the match recorded in shared memory, the
//        anchor retired in a shared bitset, and every head on that anchor
//        advanced along its list. No __syncthreads inside the chain; the
//        block writes the matches out at the end;
//     3. when an exhausted column's bound beats every head, the whole block
//        rescans every exhausted column from device memory, skipping retired
//        anchors, into new top-T lists (a refill), and warp 0 resumes.
//
// The kernels only move values, never compute one, so they agree bit for
// bit with the plain propose/accept rounds (ops/matching_cuda.py).
//
// What bounds it on the card: the bytes are small (the valid columns once, a
// 32-byte sector per row when they are a short prefix: 3.1 MB at b8 with 8
// GTs; 78.5 MB with all 200), so at the train step's shapes the time is
// chains of dependent instructions: the first pass's load -> merge -> warp
// selection per block, then num_gt serial steps of one warp, and the launch
// gap. chip_smoke.py times both kernels (PERF.md).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kT = 8;          // keys per column list
constexpr int kThreads = 512;  // both kernels
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = kT;    // rows in flight per thread in a column scan (a batch)
constexpr int kMaxCols = 256;  // L limit of the packed key
constexpr int kPerLane = kMaxCols / 32;
constexpr float kMinIou = 1e-6f;

__device__ __forceinline__ u64 make_key(float v, int a) {
  return v > kMinIou ? (static_cast<u64>(__float_as_uint(v)) << 32) |
                           static_cast<u64>(0xFFFFFFFFu - static_cast<unsigned>(a))
                     : 0ull;
}

__device__ __forceinline__ int key_anchor(u64 key) {
  return static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(key & 0xFFFFFFFFull));
}

// The greedy's order: value, then the smallest anchor, then the smallest column.
__device__ __forceinline__ u64 pack(u64 key, int col) {
  const unsigned a = static_cast<unsigned>(key_anchor(key));
  return (key & 0xFFFFFFFF00000000ull) | (static_cast<u64>(0xFFFFFFu - a) << 8) |
         static_cast<u64>(255 - col);
}

// The anchor of a packed head.
__device__ __forceinline__ int head_anchor(u64 head) {
  return static_cast<int>(0xFFFFFFu - static_cast<unsigned>((head >> 8) & 0xFFFFFFu));
}

__device__ __forceinline__ bool is_used(const unsigned* used, int a) {
  return (used[a >> 5] >> (a & 31)) & 1u;
}

__device__ __forceinline__ u64 warp_max(u64 x) {
  const unsigned hi = __reduce_max_sync(0xffffffffu, static_cast<unsigned>(x >> 32));
  const unsigned lo = __reduce_max_sync(
      0xffffffffu, static_cast<unsigned>(x >> 32) == hi ? static_cast<unsigned>(x) : 0u);
  return static_cast<u64>(hi) << 32 | lo;
}

// Sort a register batch of kT keys descending (a bitonic sorting network).
__device__ __forceinline__ void sort_desc(u64 (&a)[kT]) {
#pragma unroll
  for (int size = 2; size <= kT; size <<= 1) {
#pragma unroll
    for (int d = size >> 1; d > 0; d >>= 1) {
#pragma unroll
      for (int i = 0; i < kT; ++i) {
        const int p = i ^ d;
        if (p > i && ((i & size) == 0 ? a[i] < a[p] : a[i] > a[p])) {
          const u64 t = a[i];
          a[i] = a[p];
          a[p] = t;
        }
      }
    }
  }
}

// a = the top kT of the descending lists a and b, descending: the
// elementwise max of a and reversed b is bitonic and holds the top kT; a
// bitonic merge sorts it.
__device__ __forceinline__ void merge_into(u64 (&a)[kT], const u64 (&b)[kT]) {
#pragma unroll
  for (int i = 0; i < kT; ++i) a[i] = a[i] > b[kT - 1 - i] ? a[i] : b[kT - 1 - i];
#pragma unroll
  for (int d = kT / 2; d > 0; d >>= 1) {
#pragma unroll
    for (int i = 0; i < kT; ++i) {
      if ((i & d) == 0 && a[i] < a[i + d]) {
        const u64 t = a[i];
        a[i] = a[i + d];
        a[i + d] = t;
      }
    }
  }
}

// Every lane's `list` = the top kT of the lanes' descending lists: kT
// rounds of a warp max, after each of which the lane holding it pops it.
__device__ __forceinline__ void warp_top(u64 (&list)[kT]) {
  u64 sel[kT];
#pragma unroll
  for (int k = 0; k < kT; ++k) {
    const u64 m = warp_max(list[0]);
    sel[k] = m;
    if (m != 0ull && list[0] == m) {
#pragma unroll
      for (int i = 0; i < kT - 1; ++i) list[i] = list[i + 1];
      list[kT - 1] = 0ull;
    }
  }
#pragma unroll
  for (int k = 0; k < kT; ++k) list[k] = sel[k];
}

// cols[0..count) = the valid columns of one image, ascending; by warp 0.
__device__ void valid_columns(const bool* valid, int L, int* cols, int* count) {
  if ((threadIdx.x >> 5) != 0) return;
  const int lane = threadIdx.x & 31;
  bool v[kPerLane];  // L <= kMaxCols: every load in flight at once
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) v[k] = 32 * k + lane < L && valid[32 * k + lane];
  int n = 0;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const unsigned m = __ballot_sync(0xffffffffu, v[k]);
    if (v[k]) cols[n + __popc(m & ((1u << lane) - 1u))] = 32 * k + lane;
    n += __popc(m);
  }
  if (lane == 0) *count = n;
}

// With the whole block: for j < n, out[slot(j) * kT ...] = the top-kT keys
// (descending, 0-padded) of column cols[j] of `img` over rows [a0, a1),
// skipping retired anchors when kSkipUsed. slot(j) = slots[j], or j when
// slots is null. `merge` is kThreads * kT u64 of shared memory.
//
// Up to kWarps columns at a time, whole warps take a column (lanes on
// neighbouring rows) and select from their lanes' lists by warp max
// reductions, then merge their warps' lists through shared memory. More columns than that, threads take
// (column, row group) pairs with neighbouring threads on neighbouring
// columns of a row (coalesced), and the row groups merge through shared
// memory.
template <bool kSkipUsed>
__device__ void column_top_t(const float* __restrict__ img, int L, int a0, int a1, const int* cols,
                             const int* slots, int n, const unsigned* used, u64* merge, u64* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j0 = 0; j0 < n; j0 += kThreads) {
    const int nj = min(kThreads, n - j0);
    const bool by_warp = nj <= kWarps;
    int wc = 1, G = 1, j, g;
    if (by_warp) {
      // warps per column: up to kWarps / nj, while each lane keeps >= 2
      // batches of rows (fewer, longer lanes beat a deeper merge)
      while (wc * 2 * nj <= kWarps && wc * 2 * 32 * 2 * kUnroll <= a1 - a0) wc *= 2;
      G = wc * 32;
      j = warp / wc;
      g = (warp % wc) * 32 + lane;
    } else {
      while (G * 2 * nj <= kThreads) G *= 2;  // row groups per column
      j = threadIdx.x % nj;
      g = threadIdx.x / nj;
    }
    const bool active = by_warp ? j < nj : g < G;
    u64 list[kT];
#pragma unroll
    for (int k = 0; k < kT; ++k) list[k] = 0ull;
    if (active) {
      const float* col = img + cols[j0 + j];
      // batches of kUnroll rows; the next batch's loads are in flight while
      // this one is merged
      float next[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int au = a0 + g + u * G;
        next[u] = au < a1 ? __ldg(col + static_cast<size_t>(au) * L) : 0.0f;
      }
      for (int a = a0 + g; a < a1; a += kUnroll * G) {
        float v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          v[u] = next[u];
          const int an = a + (kUnroll + u) * G;
          next[u] = an < a1 ? __ldg(col + static_cast<size_t>(an) * L) : 0.0f;
        }
        u64 keys[kUnroll];
        u64 top = 0ull;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int au = a + u * G;
          keys[u] = au < a1 && !(kSkipUsed && is_used(used, au)) ? make_key(v[u], au) : 0ull;
          top = keys[u] > top ? keys[u] : top;
        }
        if (top > list[kT - 1]) {  // sort the batch, then merge it: no per-key branches
          sort_desc(keys);
          merge_into(list, keys);
        }
      }
    }
    int groups, group;  // lists left to merge per column, and this thread's
    if (by_warp) {
      warp_top(list);
      groups = wc;
      group = warp % wc;
      if (lane == 0 && active) {
#pragma unroll
        for (int k = 0; k < kT; ++k) merge[static_cast<size_t>(warp) * kT + k] = list[k];
      }
    } else {
      groups = G;
      group = g;
      if (active) {
#pragma unroll
        for (int k = 0; k < kT; ++k) merge[(static_cast<size_t>(g) * nj + j) * kT + k] = list[k];
      }
    }
    // the threads holding a list of their column to merge
    const bool holder = active && (!by_warp || lane == 0);
    __syncthreads();
    for (int half = groups / 2; half >= 1; half >>= 1) {
      if (holder && group < half) {
        const size_t other_at = by_warp ? static_cast<size_t>(warp + half)
                                        : static_cast<size_t>(g + half) * nj + j;
        const size_t mine = by_warp ? static_cast<size_t>(warp) : static_cast<size_t>(g) * nj + j;
        u64 other[kT];
#pragma unroll
        for (int k = 0; k < kT; ++k) other[k] = merge[other_at * kT + k];
        merge_into(list, other);
#pragma unroll
        for (int k = 0; k < kT; ++k) merge[mine * kT + k] = list[k];
      }
      __syncthreads();
    }
    if (holder && group == 0) {
      u64* dst = out + static_cast<size_t>(slots ? slots[j0 + j] : j0 + j) * kT;
#pragma unroll
      for (int k = 0; k < kT; ++k) dst[k] = list[k];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
match_topk_kernel(const float* __restrict__ iou, const bool* __restrict__ col_valid,
                  bool* __restrict__ matched, int* __restrict__ match_gt,
                  float* __restrict__ match_iou, u64* __restrict__ scratch, int A, int L, int S) {
  extern __shared__ u64 smem[];
  u64* merge = smem;                                       // [kThreads * kT]
  int* cols = reinterpret_cast<int*>(merge + kThreads * kT);  // [L]
  __shared__ int s_n;

  const int s = blockIdx.x;
  const size_t b = blockIdx.y;
  const int a0 = static_cast<int>(static_cast<long long>(A) * s / S);
  const int a1 = static_cast<int>(static_cast<long long>(A) * (s + 1) / S);
  for (int a = a0 + threadIdx.x; a < a1; a += kThreads) {
    matched[b * A + a] = false;
    match_gt[b * A + a] = -1;
    match_iou[b * A + a] = -1.0f;
  }
  valid_columns(col_valid + b * L, L, cols, &s_n);
  __syncthreads();
  column_top_t<false>(iou + b * A * L, L, a0, a1, cols, nullptr, s_n, nullptr, merge,
                      scratch + (b * S + s) * L * kT);
}

// The state of one column of warp 0's lane: list pointer, packed head (0
// when none), packed bound of an exhausted full list (0 otherwise).
__device__ __forceinline__ void advance(const u64* list, const unsigned* used, int col, int& ptr,
                                        u64& head, u64& bound) {
  while (ptr < kT) {
    const u64 e = list[ptr];
    if (e == 0ull) {  // the list held every positive key: nothing left
      ptr = kT;
      head = bound = 0ull;
      return;
    }
    if (!is_used(used, key_anchor(e))) {
      head = pack(e, col);
      bound = 0ull;
      return;
    }
    ++ptr;
  }
  head = 0ull;
  bound = pack(list[kT - 1], col);  // what the column has left is below this
}

// The shared-memory state of one image's greedy (match_greedy_kernel).
struct Greedy {
  const float* img;
  int A, L, n;
  const int* cols;
  u64* lists;
  u64* merge;
  unsigned* used;
  int *refill_col, *refill_slot, *rec_anchor, *rec_col;
  float* rec_iou;
  int *s_nr, *s_done, *s_refills, *s_matches;
};

// Steps 2-3 of match_greedy_kernel, with the whole block: warp 0 runs the
// greedy over the columns' lists, kCols columns per lane (j = lane + 32 k),
// and the block refills exhausted columns when warp 0 asks.
template <int kCols>
__device__ void run_greedy(const Greedy& g) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int ck[kCols], pk[kCols];
  u64 hk[kCols], bk[kCols];
  unsigned pending = (1u << kCols) - 1u;  // columns whose head is to be found
  int matches = 0;                        // warp 0's count of records
  while (true) {
    if (warp == 0) {
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int j = lane + 32 * k;
        if ((pending >> k) & 1u) {
          if (j < g.n) {
            ck[k] = g.cols[j];
            pk[k] = 0;
            advance(g.lists + static_cast<size_t>(j) * kT, g.used, ck[k], pk[k], hk[k], bk[k]);
          } else {
            ck[k] = -1;
            hk[k] = bk[k] = 0ull;
          }
        }
      }
      pending = 0u;
      if (lane == 0) *g.s_nr = 0;
      __syncwarp();
      while (true) {
        u64 m[kCols];  // the lane's largest head or bound, by a tree
#pragma unroll
        for (int k = 0; k < kCols; ++k) m[k] = hk[k] > bk[k] ? hk[k] : bk[k];
#pragma unroll
        for (int d = kCols / 2; d > 0; d >>= 1) {
#pragma unroll
          for (int k = 0; k < d; ++k) m[k] = m[k] > m[k + d] ? m[k] : m[k + d];
        }
        u64 need = 0ull;
#pragma unroll
        for (int k = 0; k < kCols; ++k) need = bk[k] > need ? bk[k] : need;
        const u64 best = warp_max(m[0]);
        if (__any_sync(0xffffffffu, need != 0ull && need == best)) {
          // an exhausted column may hold the next match: refill every
          // exhausted column (each needs it before it can be matched)
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            if (bk[k] != 0ull) {
              const int slot = atomicAdd(g.s_nr, 1);
              g.refill_col[slot] = ck[k];
              g.refill_slot[slot] = lane + 32 * k;
              pending |= 1u << k;
              bk[k] = 0ull;
            }
          }
          if (lane == 0) *g.s_done = 0;
          break;
        }
        if (best == 0ull) {  // no pair above 1e-6 is left
          if (lane == 0) {
            *g.s_done = 1;
            *g.s_matches = matches;
          }
          break;
        }
        const int a = head_anchor(best);
        const int l = 255 - static_cast<int>(best & 0xFFu);
        if (lane == 0) {
          g.rec_anchor[matches] = a;
          g.rec_col[matches] = l;
          g.rec_iou[matches] = __uint_as_float(static_cast<unsigned>(best >> 32));
          g.used[a >> 5] |= 1u << (a & 31);
        }
        ++matches;
        __syncwarp();
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          if (ck[k] == l) {  // the column is matched: closed for good
            hk[k] = bk[k] = 0ull;
            pk[k] = kT;
          } else if (hk[k] != 0ull && head_anchor(hk[k]) == a) {
            advance(g.lists + static_cast<size_t>(lane + 32 * k) * kT, g.used, ck[k], pk[k], hk[k],
                    bk[k]);
          }
        }
      }
    }
    __syncthreads();
    if (*g.s_done) break;
    column_top_t<true>(g.img, g.L, 0, g.A, g.refill_col, g.refill_slot, *g.s_nr, g.used, g.merge,
                        g.lists);
    if (threadIdx.x == 0) *g.s_refills += *g.s_nr;
  }
}

__global__ void __launch_bounds__(kThreads)
match_greedy_kernel(const float* __restrict__ iou, const bool* __restrict__ col_valid,
                    bool* __restrict__ matched, int* __restrict__ match_gt,
                    float* __restrict__ match_iou, const u64* __restrict__ scratch,
                    int* __restrict__ refills, int A, int L, int S) {
  extern __shared__ u64 smem[];
  u64* lists = smem;                                   // [L * kT]
  u64* merge = lists + static_cast<size_t>(L) * kT;    // [kThreads * kT]
  unsigned* used = reinterpret_cast<unsigned*>(merge + kThreads * kT);  // [ceil(A / 32)]
  int* cols = reinterpret_cast<int*>(used + (A + 31) / 32);            // [L]
  int* refill_col = cols + L;                                          // [L]
  int* refill_slot = refill_col + L;                                   // [L]
  int* rec_anchor = refill_slot + L;                                   // [L] matches, in order
  int* rec_col = rec_anchor + L;                                       // [L]
  float* rec_iou = reinterpret_cast<float*>(rec_col + L);              // [L]
  __shared__ int s_n, s_nr, s_done, s_refills, s_matches;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t b = blockIdx.x;
  const float* img = iou + b * A * L;

  for (int w = threadIdx.x; w < (A + 31) / 32; w += kThreads) used[w] = 0u;
  if (threadIdx.x == 0) s_refills = 0;
  valid_columns(col_valid + b * L, L, cols, &s_n);
  __syncthreads();
  const int n = s_n;

  // 1. one top-T list per valid column from the S chunk lists
  for (int j = warp; j < n; j += kWarps) {
    u64 acc[kT], other[kT];
#pragma unroll
    for (int k = 0; k < kT; ++k) acc[k] = 0ull;
    for (int s = lane; s < S; s += 64) {  // two lists in flight per lane, 16-byte loads
      u64 second[kT];
      const ulonglong2* src = reinterpret_cast<const ulonglong2*>(scratch + ((b * S + s) * L + j) * kT);
      const ulonglong2* src2 = src + static_cast<size_t>(32) * L * kT / 2;
#pragma unroll
      for (int k = 0; k < kT / 2; ++k) {
        const ulonglong2 x = src[k];
        const ulonglong2 y = s + 32 < S ? src2[k] : make_ulonglong2(0ull, 0ull);
        other[2 * k] = x.x;
        other[2 * k + 1] = x.y;
        second[2 * k] = y.x;
        second[2 * k + 1] = y.y;
      }
      merge_into(acc, other);
      merge_into(acc, second);
    }
    warp_top(acc);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kT; ++k) lists[static_cast<size_t>(j) * kT + k] = acc[k];
    }
  }
  __syncthreads();

  // 2-3. the greedy in warp 0, refills by the whole block
  const Greedy g{img, A, L, n, cols, lists, merge, used, refill_col, refill_slot, rec_anchor,
                 rec_col, rec_iou, &s_nr, &s_done, &s_refills, &s_matches};
  if (n <= 32) {
    run_greedy<1>(g);
  } else if (n <= 64) {
    run_greedy<2>(g);
  } else if (n <= 128) {
    run_greedy<4>(g);
  } else {
    run_greedy<8>(g);
  }
  for (int m = threadIdx.x; m < s_matches; m += kThreads) {
    const int a = rec_anchor[m];
    matched[b * A + a] = true;
    match_gt[b * A + a] = rec_col[m];
    match_iou[b * A + a] = rec_iou[m];
  }
  if (refills != nullptr && threadIdx.x == 0) refills[b] = s_refills;
}

// Let `kernel` use up to `bytes` of shared memory, dynamic and static.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, int bytes) {
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes - static_cast<int>(fa.sharedSizeBytes));
}

}  // namespace

extern "C" {

// Let both kernels use up to `bytes` of shared memory (dynamic and static)
// on the current device; the wrapper calls it once per device.
int dspnet_match_configure(int bytes) {
  cudaError_t err = allow_shared(match_topk_kernel, bytes);
  if (err != cudaSuccess) return err;
  // two first-pass blocks per SM need the largest shared-memory carveout
  err = cudaFuncSetAttribute(match_topk_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return err != cudaSuccess ? err : allow_shared(match_greedy_kernel, bytes);
}

// iou (B, A, L) f32 and col_valid (B, L) bool, contiguous on the current
// device; matched (B, A) bool, match_gt (B, A) int32 and match_iou (B, A)
// f32 out (-1 where unmatched); scratch (B, S, L, kT) u64; refills (B,)
// int32 out (columns rescanned from device memory per image) or null. The
// plan (ops/matching_cuda.py's launch_plan, the one owner of these sizes and
// of the shape limits L <= 256, A < 2^24) gives S and the two kernels'
// shared bytes. Launches on `stream`; returns cudaGetLastError().
int dspnet_bipartite_match(const void* iou, const void* col_valid, void* matched, void* match_gt,
                           void* match_iou, void* scratch, void* refills, int B, int A, int L,
                           int S, int smem_topk, int smem_greedy, void* stream) {
  if (B <= 0 || A <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(iou);
  const bool* v = static_cast<const bool*>(col_valid);
  bool* m = static_cast<bool*>(matched);
  int* g = static_cast<int*>(match_gt);
  float* val = static_cast<float*>(match_iou);
  u64* sc = static_cast<u64*>(scratch);
  match_topk_kernel<<<dim3(S, B), kThreads, smem_topk, s>>>(x, v, m, g, val, sc, A, L, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  match_greedy_kernel<<<B, kThreads, smem_greedy, s>>>(x, v, m, g, val, sc,
                                                       static_cast<int*>(refills), A, L, S);
  return cudaGetLastError();
}

const char* dspnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
