// A host emulation of the few CUDA runtime pieces dspnet_torch/csrc/av1.cu
// and csrc/h264.cu use, so that the source compiles with g++ and its kernels run on the CPU
// for tests: each CUDA thread of a block is a std::thread, __syncthreads is
// a std::barrier over the block, blocks run one after another, __shared__
// variables are static (one block at a time shares them). Build with
//   g++ -std=c++20 -O1 -fPIC -shared -I tests/cuda_emulation -x c++ \
//       dspnet_torch/csrc/av1.cu -o libav1_emulated.so -lpthread
// (tests/test_torch_avif_emulated.py does).
#pragma once
#include <algorithm>
#include <barrier>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

using std::max;
using std::min;

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* emu_barrier = nullptr;

typedef int cudaError_t;
typedef void* cudaStream_t;
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "no error (host emulation)"; }

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __restrict__
#define __constant__ static
#define __shared__ static

inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
inline unsigned long long atomicAdd(unsigned long long* a, unsigned long long v) {
  return __atomic_fetch_add(a, v, __ATOMIC_SEQ_CST);
}

template <class K>
struct EmuLaunch {
  K kernel;
  dim3 grid, block;
  template <class... A>
  void operator()(A... args) {
    gridDim = grid;
    blockDim = block;
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::barrier<> bar(block.x);
        emu_barrier = &bar;
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < block.x; ++t)
          threads.emplace_back([&, t] {
            threadIdx = dim3(t);
            blockIdx = dim3(bx, by);
            kernel(args...);
          });
        for (auto& th : threads) th.join();
      }
  }
};
template <class K>
EmuLaunch<K> emu_launch(K kernel, dim3 grid, dim3 block) {
  return EmuLaunch<K>{kernel, grid, block};
}
#define AV1_LAUNCH(kernel, grid, block, stream) emu_launch(kernel, dim3(grid), dim3(block))
#define H264_LAUNCH(kernel, grid, block, stream) emu_launch(kernel, dim3(grid), dim3(block))
