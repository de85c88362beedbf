// A host emulation of the few CUDA runtime pieces dspnet_torch/csrc/av1.cu,
// csrc/h264.cu and csrc/mpeg4.cu use, so that the source compiles with g++ and its kernels
// run on the CPU for tests. The CUDA threads of a block are fibers (ucontext)
// of the calling thread, each on its own stack, set up once a launch and
// restarted for every block of the grid; __syncthreads passes control to the
// next fiber in turn, so a block's threads all reach a barrier before any
// passes it, and the emulation takes one core however many threads a block
// has (the tests run beside others). Blocks run one after another;
// __shared__ variables are static (one block at a time shares them), and
// a launch's dynamic shared memory (DYNAMIC_SHARED) one buffer of the size
// the launch names. __syncwarp is __syncthreads (a block of at most 32
// threads is one warp).
// Atomics, fences and L2 loads act on host memory; a kernel that waits on a
// block with a smaller index (rows taken in order by a ticket) never waits
// here. Build with
//   g++ -std=c++20 -O1 -fPIC -shared -I tests/cuda_emulation -x c++
//       dspnet_torch/csrc/av1.cu -o libav1_emulated.so
// (tests/test_torch_avif_emulated.py does).
#pragma once
#include <ucontext.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <vector>

using std::max;
using std::min;

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline dim3 threadIdx, blockIdx, blockDim, gridDim;

struct uint2 {
  unsigned x, y;
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
inline uint2 make_uint2(unsigned x, unsigned y) { return uint2{x, y}; }
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return uint4{x, y, z, w}; }
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
inline unsigned __umulhi(unsigned a, unsigned b) { return (unsigned)(((unsigned long long)a * b) >> 32); }
// byte i of the result is byte (s >> 4i) & 7 of the 8 bytes y:x
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const unsigned long long v = ((unsigned long long)y << 32) | x;
  unsigned r = 0;
  for (int i = 0; i < 4; i++) r |= (unsigned)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
  return r;
}
inline int __clzll(long long x) { return x ? __builtin_clzll((unsigned long long)x) : 64; }

typedef int cudaError_t;
typedef void* cudaStream_t;
inline cudaError_t cudaGetLastError() { return 0; }
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return 0;
}
inline const char* cudaGetErrorString(cudaError_t) { return "no error (host emulation)"; }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return 0;
}
// a card of 4 SMs with room for 2 blocks each
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return 0;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 4;
  return 0;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 2;
  return 0;
}

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __restrict__
#define __constant__ static
#define __shared__ static
#define __align__(n) alignas(n)

// the running launch's dynamic shared memory
inline std::vector<uint4> emu_dynamic_shared;
#define DYNAMIC_SHARED(name) uint8_t* name = reinterpret_cast<uint8_t*>(emu_dynamic_shared.data())

// the fibers of the running block
struct EmuBlock {
  static constexpr size_t STACK = 1 << 20;  // bytes a fiber
  unsigned n = 0, cur = 0, finished = 0;
  std::vector<ucontext_t> ctx;
  std::vector<char> done;
  std::vector<std::unique_ptr<char[]>> stacks;
  ucontext_t caller;
  std::function<void()> body;
  void fibers(unsigned threads) {  // stacks kept for later launches
    n = threads;
    ctx.resize(n);
    done.assign(n, 0);
    while (stacks.size() < n) stacks.emplace_back(new char[STACK]);
  }
  void next() {  // from fiber cur to the next one that has not ended
    unsigned me = cur, to = (cur + 1) % n;
    while (done[to]) to = (to + 1) % n;
    if (to == me) return;
    cur = to;
    threadIdx = dim3(to);
    swapcontext(&ctx[me], &ctx[to]);
  }
};
inline EmuBlock emu_block;

inline void emu_fiber_main() {
  emu_block.body();
  emu_block.done[emu_block.cur] = 1;
  if (++emu_block.finished == emu_block.n) setcontext(&emu_block.caller);
  emu_block.next();  // never returns here
}

inline void __syncthreads() {
  if (emu_block.n > 1) emu_block.next();
}
inline void __syncwarp(unsigned = 0xFFFFFFFFu) { __syncthreads(); }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
template <class T>
inline T __ldcg(const T* p) {
  return *p;
}
inline unsigned long long atomicAdd(unsigned long long* a, unsigned long long v) {
  return __atomic_fetch_add(a, v, __ATOMIC_SEQ_CST);
}
inline int atomicAdd(int* a, int v) { return __atomic_fetch_add(a, v, __ATOMIC_SEQ_CST); }

template <class K>
struct EmuLaunch {
  K kernel;
  dim3 grid, block;
  size_t shared;
  template <class... A>
  void operator()(A... args) {
    gridDim = grid;
    blockDim = block;
    emu_dynamic_shared.assign((shared + 15) / 16, uint4{});
    EmuBlock& b = emu_block;
    b.fibers(block.x);
    b.body = [&] { kernel(args...); };
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        blockIdx = dim3(bx, by);
        if (block.x == 1) {
          threadIdx = dim3(0);
          b.n = 1;
          kernel(args...);
          continue;
        }
        for (unsigned t = 0; t < block.x; ++t) {
          getcontext(&b.ctx[t]);
          b.ctx[t].uc_stack.ss_sp = b.stacks[t].get();
          b.ctx[t].uc_stack.ss_size = EmuBlock::STACK;
          b.ctx[t].uc_link = nullptr;
          makecontext(&b.ctx[t], emu_fiber_main, 0);
        }
        std::fill(b.done.begin(), b.done.end(), 0);
        b.finished = 0;
        b.cur = 0;
        threadIdx = dim3(0);
        swapcontext(&b.caller, &b.ctx[0]);
      }
  }
};
template <class K>
EmuLaunch<K> emu_launch(K kernel, dim3 grid, dim3 block, size_t shared = 0) {
  return EmuLaunch<K>{kernel, grid, block, shared};
}
#define AV1_LAUNCH(kernel, grid, block, stream) emu_launch(kernel, dim3(grid), dim3(block))
#define H264_LAUNCH(kernel, grid, block, stream) emu_launch(kernel, dim3(grid), dim3(block))
#define H264_LAUNCH_SHARED(kernel, grid, block, shared, stream) emu_launch(kernel, dim3(grid), dim3(block), shared)
#define MP4V_LAUNCH(kernel, grid, block, shared, stream) emu_launch(kernel, dim3(grid), dim3(block), shared)
