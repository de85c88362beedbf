// Greedy class-aware NMS keep mask for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel dspnet_tpu/ops/nms_pallas.py::_nms_kernel, which
// builds a dense K x K f32 suppression matrix in VMEM and iterates the
// fixpoint keep = valid & ~(keep @ S) on the MXU. That shape exists for the
// TPU's matrix unit. Here the same mask is a bitmask, one u64 word per (row,
// 64-column tile): bit t of word (i, w) says row i suppresses row
// j = 64 w + t (j > i, both valid, same class unless force_suppress, and
// iou(i, j) >= thr). Greedy NMS then walks the rows in order, which the TPU
// kernel's fixpoint equals.
//
// Two paths, chosen by the wrapper's launch plan (ops/nms_cuda.py), a pure
// function of (B, K):
//
//   shared-memory mask (K up to 1,216, the serving path's K = 400): ONE launch,
//     nms_image_kernel. A cluster of `cluster` blocks per image (Hopper thread
//     block clusters) builds the image's mask into the leader block's shared
//     memory through distributed shared memory; with cluster = 1 one block
//     builds it alone. A warp takes a row and builds its words; for word w a
//     lane tests columns 64 w + lane and 64 w + 32 + lane, and two ballots
//     make the word. Tiles left of the diagonal and invalid rows are never
//     built (never read).
//     The remote writes need no atomics: every word read later (row i's
//     words from tile(i) on, for a valid row i) is written once, by the one
//     warp that owns row i, with a plain 64-bit store, and no block reads or
//     initialises a word another block writes. The first cluster.sync makes
//     every block resident before any store reaches the leader's shared
//     memory; the second (arrive.release, wait.acquire) orders every store
//     before the leader's first read, and after it no block touches another's
//     shared memory, so the others may exit. The words nobody writes are read
//     only as invalid rows' diagonal words by the transpose, and the scan
//     masks those bits (an invalid row is never a candidate, never kept).
//   device-memory mask (larger K, up to A = 12,264 when nms_topk <= 0): two
//     launches. nms_mask_kernel writes the upper-triangular words of valid
//     rows to a (B, K, T) u64 scratch; nms_scan_kernel stages one 64-row tile
//     at a time into shared memory (only rows still candidates) and scans it.
//
// The scan is the same on both paths (scan_tile), by warp 0, tile by tile:
//   1. each row's suppressors inside its tile (lane l holds rows l and
//      l + 32) are the tile's diagonal words transposed by ballots (on the
//      shared-memory path for every tile at once, a warp per tile, before
//      the scan); the greedy over the tile then resolves as a wavefront of
//      warp rounds (a row with a kept suppressor is removed, one whose
//      suppressors are all out is kept): a few rounds, where a sequential
//      chain over the 64 rows is 64 dependent steps of a lone warp;
//   2. the kept rows' words are ORed into `removed` of the later tiles, a
//      warp OR reduction per tile;
//   3. `keep` is one u64 per tile in shared memory, expanded to bool by the
//      whole block at the end. A tile with no candidate is skipped.
//
// What bounds it on the card. The bytes are nothing (8.8 KB per image at
// K = 400) and so are the operations at the card's rate; the time is
// instruction latency: the build, ~110k pair tests per image at K = 400 at
// ~20 instructions each, which the cluster spreads over up to 16 SMs while
// B leaves SMs idle (at large B every SM has its own images), then the
// scan's short warp chains per 64-row tile. chip_smoke.py times the call on
// one block and on the cluster (PERF.md).
//
// Exactness: the IoU is computed in the JAX order with round-to-nearest
// intrinsics (no FMA contraction of (area_i + area_j) - inter). `iou >= thr`
// is decided without the division where the sign of inter - thr * union,
// taken by one fused multiply-add, settles it far from the threshold; near
// the threshold (a relative gap under 2^-21) the IEEE division decides, so
// the result is that of `__fdiv_rn(inter, union) >= thr`, bit for bit with
// the plain version.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

constexpr int kTile = 64;       // rows / columns per mask word
constexpr int kThreads = 1024;  // nms_image_kernel and nms_scan_kernel
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// The pair test, without branches: `decided` when the sign of
// inter - thr * union, taken by one FMA, settles iou >= thr (then `result`
// is the answer; the header note says why this is exact); otherwise the
// IEEE division of `inter` by `uni` decides (divide).
struct PairTest {
  float inter, uni;
  bool decided, result;
};

__device__ __forceinline__ PairTest pair_test(float4 a, float area_a, float4 b, float area_b,
                                              float thr) {
  PairTest p;
  const float iw = fmaxf(0.0f, __fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)));
  const float ih = fmaxf(0.0f, __fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)));
  p.inter = __fmul_rn(iw, ih);
  p.uni = __fsub_rn(__fadd_rn(area_a, area_b), p.inter);
  const float tu = __fmul_rn(thr, p.uni);
  const float r = __fmaf_rn(-thr, p.uni, p.inter);  // sign of inter - thr * uni
  const bool normal = tu > 1e-30f;
  p.result = normal && r > 0.0f;                          // ratio >= thr: RN(ratio) >= thr
  p.decided = p.result || (normal && r < -tu * 0x1p-20f);  // ratio < thr (1 - 2^-21) < pred(thr)
  return p;
}

__device__ __forceinline__ bool divide(const PairTest& p, float thr) {
  return (p.uni > 0.0f ? __fdiv_rn(p.inter, p.uni) : 0.0f) >= thr;
}

// The class key: the id of a valid row (0 for every valid row under
// force_suppress), NaN for an invalid one, so one `==` tests both.
__device__ __forceinline__ float class_key(float id, bool valid, int force_suppress) {
  return valid ? (force_suppress ? 0.0f : id) : __int_as_float(0x7fc00000);
}

// validw[w] = the valid bits of tile w; removed[w] = 0. Run by every warp.
__device__ void init_words(const bool* valid, int K, int T, u64* validw, u64* removed) {
  const int lane = threadIdx.x & 31;
  for (int w = threadIdx.x >> 5; w < T; w += blockDim.x >> 5) {
    const int j0 = w * kTile + lane, j1 = j0 + 32;
    const unsigned lo = __ballot_sync(0xffffffffu, j0 < K && valid[j0]);
    const unsigned hi = __ballot_sync(0xffffffffu, j1 < K && valid[j1]);
    if (lane == 0) {
      validw[w] = static_cast<u64>(hi) << 32 | lo;
      removed[w] = 0ull;
    }
  }
}

// inc0, inc1 = the rows of tile t that suppress row `lane`, row `lane + 32`
// of the tile: the tile's diagonal words (row r's word t at rows[r * T + t],
// `nrows` rows) transposed by ballots. By one whole warp.
__device__ __forceinline__ void transpose_diag(const u64* rows, int T, int t, int nrows, u64& inc0,
                                               u64& inc1) {
  const int lane = threadIdx.x & 31;
  const u64 d0 = lane < nrows ? rows[static_cast<size_t>(lane) * T + t] : 0ull;
  const u64 d1 = lane + 32 < nrows ? rows[static_cast<size_t>(lane + 32) * T + t] : 0ull;
  inc0 = inc1 = 0ull;
#pragma unroll
  for (int c = 0; c < 32; ++c) {  // rows 32..63 never suppress a row below 33
    const unsigned lo = __ballot_sync(0xffffffffu, (d0 >> c) & 1ull);
    if (lane == c) inc0 = lo;
  }
#pragma unroll
  for (int c = 32; c < 64; ++c) {
    const unsigned lo = __ballot_sync(0xffffffffu, (d0 >> c) & 1ull);
    const unsigned hi = __ballot_sync(0xffffffffu, (d1 >> c) & 1ull);
    if (lane == c - 32) inc1 = static_cast<u64>(hi) << 32 | lo;
  }
}

// Resolve tile t of a scan, by one whole warp. `cand` holds the tile's rows
// that are valid and not removed by earlier tiles; inc0 and inc1 the rows of
// the tile that suppress row `lane` and row `lane + 32`. The greedy over the
// tile resolves as a wavefront: a candidate with a kept suppressor is
// removed, one whose suppressors are all out (removed, or not candidates) is
// kept, and each round the earliest undecided row decides, so the rounds end;
// usually in a few, where a sequential chain over the rows takes 64 steps.
// Then the kept rows' words (row r's word w at rows[r * T + w]) are ORed
// into removed[t+1..T-1]. Returns the kept bits.
__device__ __forceinline__ u64 scan_tile(const u64* rows, int T, int t, u64 cand, u64 inc0,
                                         u64 inc1, u64* removed) {
  const int lane = threadIdx.x & 31;
  const unsigned full = 0xffffffffu;
  const bool c0 = (cand >> lane) & 1ull, c1 = (cand >> (lane + 32)) & 1ull;
  u64 kept = 0ull, out = ~cand;
  while (~(kept | out)) {
    const bool k0 = c0 && !(inc0 & ~out);  // no suppressor kept or undecided
    const bool k1 = c1 && !(inc1 & ~out);
    const bool r0 = c0 && (inc0 & kept);
    const bool r1 = c1 && (inc1 & kept);
    kept |= static_cast<u64>(__ballot_sync(full, k1)) << 32 | __ballot_sync(full, k0);
    out |= static_cast<u64>(__ballot_sync(full, r1)) << 32 | __ballot_sync(full, r0);
  }
  // one OR reduction across the warp per later word
  const bool k0 = (kept >> lane) & 1ull, k1 = (kept >> (lane + 32)) & 1ull;
  const u64* r0 = rows + static_cast<size_t>(lane) * T;
  const u64* r1 = r0 + static_cast<size_t>(32) * T;
#pragma unroll 4
  for (int w = t + 1; w < T; ++w) {
    const u64 x = (k0 ? r0[w] : 0ull) | (k1 ? r1[w] : 0ull);
    const unsigned lo = __reduce_or_sync(full, static_cast<unsigned>(x));
    const unsigned hi = __reduce_or_sync(full, static_cast<unsigned>(x >> 32));
    if (lane == 0) removed[w] |= static_cast<u64>(hi) << 32 | lo;
  }
  __syncwarp();
  return kept;
}

// keep[i] = bit i of keepw, by the whole block.
__device__ void expand_keep(const u64* keepw, int K, bool* keep) {
  for (int i = threadIdx.x; i < K; i += blockDim.x) keep[i] = (keepw[i >> 6] >> (i & 63)) & 1ull;
}

__global__ void __launch_bounds__(kThreads, 1)
nms_image_kernel(const float4* __restrict__ boxes, const float* __restrict__ ids,
                 const bool* __restrict__ valid, bool* __restrict__ keep, int K, int T, float thr,
                 int force_suppress, int cluster) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* sbox = reinterpret_cast<float4*>(smem_raw);
  float2* sinfo = reinterpret_cast<float2*>(sbox + K);  // (area, class key)
  u64* mask = reinterpret_cast<u64*>(sinfo + K);        // [K * T]
  u64* inc = mask + static_cast<size_t>(K) * T;         // [K]
  u64* validw = inc + K;
  u64* removed = validw + T;
  u64* keepw = removed + T;

  const int rank = blockIdx.x;  // rank in the image's cluster; 0 is the leader
  const size_t base = static_cast<size_t>(blockIdx.y) * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < K; i += kThreads) {
    const float4 b = boxes[base + i];
    sbox[i] = b;
    sinfo[i] = make_float2(area(b), class_key(ids[base + i], valid[base + i], force_suppress));
  }
  if (rank == 0) init_words(valid + base, K, T, validw, removed);
  u64* dst = mask;
  if (cluster > 1) {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();  // every block of the cluster has started and loaded its boxes
    dst = cl.map_shared_rank(mask, 0);
  } else {
    __syncthreads();
  }

  // the mask: a warp takes a valid row i and builds its words w >= tile(i)
  // (independent of one another, so the loop keeps several in flight)
  for (int i = rank * kWarps + warp; i < K; i += cluster * kWarps) {
    const float2 info = sinfo[i];
    if (info.y != info.y) continue;  // invalid row: never read
    const float4 bi = sbox[i];
    u64* row = dst + static_cast<size_t>(i) * T;
#pragma unroll 2
    for (int w = i >> 6; w < T; ++w) {
      const int j0 = w * kTile + lane, j1 = j0 + 32;
      const int c0 = min(j0, K - 1), c1 = min(j1, K - 1);
      const float2 o0 = sinfo[c0], o1 = sinfo[c1];
      const bool same0 = j0 < K && o0.y == info.y, same1 = j1 < K && o1.y == info.y;
      const PairTest t0 = pair_test(bi, info.x, sbox[c0], o0.x, thr);
      const PairTest t1 = pair_test(bi, info.x, sbox[c1], o1.x, thr);
      bool p0 = same0 && t0.result, p1 = same1 && t1.result;
      const bool div0 = same0 && !t0.decided, div1 = same1 && !t1.decided;
      if (__any_sync(0xffffffffu, div0 || div1)) {  // near the threshold: the IEEE division
        if (div0) p0 = divide(t0, thr);
        if (div1) p1 = divide(t1, thr);
      }
      u64 word = static_cast<u64>(__ballot_sync(0xffffffffu, p1)) << 32 |
                 __ballot_sync(0xffffffffu, p0);
      if (w == (i >> 6)) word &= ~((2ull << (i & 63)) - 1ull);  // only j > i
      if (lane == 0) row[w] = word;
    }
  }
  if (cluster > 1) {
    cg::this_cluster().sync();  // the leader's mask is complete
    if (rank != 0) return;
  } else {
    __syncthreads();
  }
  // each tile's suppressors, a warp per tile, all tiles at once
  for (int t = warp; t < T; t += kWarps) {
    u64 inc0, inc1;
    transpose_diag(mask + static_cast<size_t>(t) * kTile * T, T, t, min(kTile, K - t * kTile),
                   inc0, inc1);
    const int i0 = t * kTile + lane, i1 = i0 + 32;
    if (i0 < K) inc[i0] = inc0;
    if (i1 < K) inc[i1] = inc1;
  }
  __syncthreads();

  if (warp == 0) {
    for (int t = 0; t < T; ++t) {
      const u64 cand = validw[t] & ~removed[t];
      u64 kept = 0ull;
      if (cand) {
        const int i0 = t * kTile + lane, i1 = i0 + 32;
        kept = scan_tile(mask + static_cast<size_t>(t) * kTile * T, T, t, cand,
                         i0 < K ? inc[i0] : 0ull, i1 < K ? inc[i1] : 0ull, removed);
      }
      if (lane == 0) keepw[t] = kept;
    }
  }
  __syncthreads();
  expand_keep(keepw, K, keep + base);
}

// Device-memory path, launch 1: grid (T, T, B), 64 threads. Thread i of tile
// (row_tile, col_tile) writes mask[b, i, col_tile] for a valid row i and
// col_tile >= row_tile; the other words are never read.
__global__ void nms_mask_kernel(const float4* __restrict__ boxes, const float* __restrict__ ids,
                                const bool* __restrict__ valid, u64* __restrict__ mask, int K,
                                int T, float thr, int force_suppress) {
  const int col_tile = blockIdx.x;
  const int row_tile = blockIdx.y;
  if (col_tile < row_tile) return;
  const size_t base = static_cast<size_t>(blockIdx.z) * K;
  const int j0 = col_tile * kTile;
  const int ncols = min(kTile, K - j0);

  __shared__ float4 col_box[kTile];
  __shared__ float2 col_info[kTile];
  if (threadIdx.x < ncols) {
    const float4 b = boxes[base + j0 + threadIdx.x];
    col_box[threadIdx.x] = b;
    col_info[threadIdx.x] = make_float2(
        area(b), class_key(ids[base + j0 + threadIdx.x], valid[base + j0 + threadIdx.x],
                           force_suppress));
  }
  __syncthreads();

  const int i = row_tile * kTile + threadIdx.x;
  if (i >= K || !valid[base + i]) return;
  const float4 box = boxes[base + i];
  const float a = area(box);
  const float key = class_key(ids[base + i], true, force_suppress);
  u64 bits = 0;
  const int start = col_tile == row_tile ? threadIdx.x + 1 : 0;
  for (int t = start; t < ncols; ++t) {
    if (col_info[t].y == key) {
      const PairTest p = pair_test(box, a, col_box[t], col_info[t].x, thr);
      if (p.decided ? p.result : divide(p, thr)) bits |= 1ull << t;
    }
  }
  mask[(base + i) * T + col_tile] = bits;
}

// Device-memory path, launch 2: one block per image stages tile t's
// candidate rows (words t..T-1) into shared memory and scans them.
__global__ void __launch_bounds__(kThreads)
nms_scan_kernel(const u64* __restrict__ mask, const bool* __restrict__ valid,
                bool* __restrict__ keep, int K, int T) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  u64* stage = reinterpret_cast<u64*>(smem_raw);  // [kTile * T]
  u64* validw = stage + static_cast<size_t>(kTile) * T;
  u64* removed = validw + T;
  u64* keepw = removed + T;

  const size_t base = static_cast<size_t>(blockIdx.x) * K;
  const u64* img = mask + base * T;
  init_words(valid + base, K, T, validw, removed);
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const u64 cand = validw[t] & ~removed[t];  // the same value in every thread
    if (cand == 0ull) {
      if (threadIdx.x == 0) keepw[t] = 0ull;
      continue;
    }
    const int span = T - t;
    const int nrows = min(kTile, K - t * kTile);
    for (int x = threadIdx.x; x < nrows * span; x += kThreads) {
      const int r = x / span, w = t + (x - r * span);
      if ((cand >> r) & 1ull)
        stage[static_cast<size_t>(r) * T + w] = img[static_cast<size_t>(t * kTile + r) * T + w];
    }
    __syncthreads();
    if ((threadIdx.x >> 5) == 0) {
      u64 inc0, inc1;
      transpose_diag(stage, T, t, nrows, inc0, inc1);
      const u64 kept = scan_tile(stage, T, t, cand, inc0, inc1, removed);
      if (threadIdx.x == 0) keepw[t] = kept;
    }
    __syncthreads();
  }
  expand_keep(keepw, K, keep + base);
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

// Let both block kernels use up to `bytes` of shared memory (dynamic and
// static), and the image kernel clusters of 16, on the current device; the
// wrapper calls it once per device.
int dspnet_nms_configure(int bytes) {
  cudaError_t err = allow_shared(nms_image_kernel, bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(nms_image_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err != cudaSuccess ? err : allow_shared(nms_scan_kernel, bytes);
}

// boxes (B, K, 4) f32, ids (B, K) f32, valid (B, K) bool, all contiguous on
// the current device; keep (B, K) bool out. The plan (ops/nms_cuda.py's
// launch_plan, the one owner of these sizes): shared_path 1 builds the mask
// in shared memory (one launch, `cluster` blocks per image, `smem` bytes
// each); shared_path 0 builds it in `mask`, a (B, K, ceil(K/64)) u64
// scratch, and scans with `smem` bytes. Launches on `stream`; returns
// cudaGetLastError().
int dspnet_nms_keep_mask(const void* boxes, const void* ids, const void* valid, void* mask,
                         void* keep, int B, int K, float thr, int force_suppress, int shared_path,
                         int cluster, int smem, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int T = (K + kTile - 1) / kTile;
  const float4* bx = static_cast<const float4*>(boxes);
  const float* id = static_cast<const float*>(ids);
  const bool* v = static_cast<const bool*>(valid);
  bool* out = static_cast<bool*>(keep);
  if (shared_path) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, B, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = cluster > 1 ? 1 : 0;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, nms_image_kernel, bx, id, v, out, K, T, thr,
                                               force_suppress, cluster);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  nms_mask_kernel<<<dim3(T, T, B), kTile, 0, s>>>(bx, id, v, static_cast<u64*>(mask), K, T, thr,
                                                  force_suppress);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nms_scan_kernel<<<B, kThreads, smem, s>>>(static_cast<const u64*>(mask), v, out, K, T);
  return cudaGetLastError();
}

const char* dspnet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
