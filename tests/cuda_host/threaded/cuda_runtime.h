// Threaded host stand-in for the CUDA runtime, so that the kernels of
// lagomorph_tpu_torch/csrc that share memory and barriers (fft_unit.cu,
// fft_radix.cu, fft_whole.cu, shoot2d.cu) compile with g++ (C++20) and run
// on the CPU (tests/test_torch_host_barrier_kernels.py).
//
// Every CUDA thread of a block is an OS thread: __syncthreads is a barrier
// of the block, __ballot_sync a vote of the warp between barriers of its 32
// threads, and a block's dynamic shared memory one buffer.  The blocks of an
// ordinary launch run in turn on one set of threads; a cooperative launch
// (the test rewrites `launch_cooperative((const void*)k, ...)` as
// `emu_launch_cooperative(k, ...)`) runs every block at once and makes
// cooperative_groups' grid.sync() a barrier of all their threads.  The test
// also rewrites each `k<<<grid, block, smem, stream>>>(args);` as
// `emu_launch(grid, block, smem, [&] { k(args); });` and `extern __shared__
// float2 s[];` as a pointer to the block's buffer.
#pragma once

#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <memory>
#include <thread>
#include <type_traits>
#include <utility>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)

struct float2 {
  float x, y;
};
inline float2 make_float2(float x, float y) { return float2{x, y}; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
// g++ binds an inline variable process-wide (STB_GNU_UNIQUE), even across
// libraries loaded with RTLD_LOCAL, so these names differ from those of
// tests/cuda_host/cuda_runtime.h, whose library may share the process
inline thread_local dim3 emu_mt_threadIdx, emu_mt_blockIdx;
inline dim3 emu_mt_blockDim, emu_mt_gridDim;
#define threadIdx emu_mt_threadIdx
#define blockIdx emu_mt_blockIdx
#define blockDim emu_mt_blockDim
#define gridDim emu_mt_gridDim

struct EmuWarp {
  std::barrier<> bar{32};
  std::atomic<unsigned> vote{0};
};
struct EmuBlock {
  std::barrier<> bar;
  std::vector<float2> smem;
  std::vector<std::unique_ptr<EmuWarp>> warps;
  EmuBlock(int n, size_t bytes) : bar(n), smem(bytes / sizeof(float2) + 1) {
    for (int w = 0; w < (n + 31) / 32; ++w) warps.emplace_back(new EmuWarp);
  }
};
inline thread_local EmuBlock* emu_block = nullptr;
inline std::barrier<>* emu_grid_bar = nullptr;
#define emu_smem_ptr (emu_block->smem.data())

inline void __syncthreads() { emu_block->bar.arrive_and_wait(); }
inline void sincospi(double x, double* s, double* c) {
  *s = std::sin(M_PI * x);
  *c = std::cos(M_PI * x);
}
inline int __clz(int x) { return __builtin_clz((unsigned)x); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
template <class T>
inline T __ldg(const T* p) { return *p; }
inline unsigned __ballot_sync(unsigned, bool pred) {
  EmuWarp& w = *emu_block->warps[threadIdx.x / 32];
  if (pred) w.vote.fetch_or(1u << (threadIdx.x % 32));
  w.bar.arrive_and_wait();
  const unsigned v = w.vote.load();
  w.bar.arrive_and_wait();
  if (threadIdx.x % 32 == 0) w.vote.store(0);
  w.bar.arrive_and_wait();
  return v;
}
inline int atomicAnd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_and(v); }

typedef int cudaError_t;
typedef struct CUstream_st* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorLaunchOutOfResources = 2 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 0 };
enum { cudaDevAttrMultiProcessorCount = 0 };
constexpr size_t kEmuMaxSmem = 232448;  // the H100's opt-in limit per block
inline cudaError_t emu_error = cudaSuccess;
inline cudaError_t cudaGetLastError() {
  const cudaError_t e = emu_error;
  emu_error = cudaSuccess;
  return e;
}
inline const char* cudaGetErrorString(cudaError_t) { return "error (host emulation)"; }
template <class T>
inline cudaError_t cudaFuncSetAttribute(T, int, int bytes) {
  return (size_t)bytes > kEmuMaxSmem ? cudaErrorInvalidValue : cudaSuccess;
}
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
// a small card: 2 SMs holding 2 blocks each, so cooperative grids have 4 blocks
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = 2;
  return cudaSuccess;
}
template <class T>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, T, int, size_t) {
  *n = 2;
  return cudaSuccess;
}
inline cudaError_t cudaLaunchCooperativeKernel(const void*, dim3, dim3, void**, size_t,
                                               cudaStream_t) {
  return cudaErrorInvalidValue;  // rewritten to emu_launch_cooperative by the test
}

template <class F>
inline void emu_run(long grid, long block, size_t smem, bool coop, F f) {
  if (block > 1024 || smem > kEmuMaxSmem) {
    emu_error = cudaErrorInvalidValue;
    return;
  }
  blockDim = dim3((unsigned)block);
  gridDim = dim3((unsigned)grid);
  std::vector<std::unique_ptr<EmuBlock>> blocks;
  std::vector<std::thread> ts;
  if (coop) {  // every block at once
    std::barrier<> gbar(grid * block);
    emu_grid_bar = &gbar;
    for (long b = 0; b < grid; ++b) blocks.emplace_back(new EmuBlock((int)block, smem));
    for (long b = 0; b < grid; ++b)
      for (long t = 0; t < block; ++t)
        ts.emplace_back([&, b, t] {
          emu_block = blocks[b].get();
          blockIdx = dim3((unsigned)b);
          threadIdx = dim3((unsigned)t);
          f();
        });
    for (auto& th : ts) th.join();
    emu_grid_bar = nullptr;
    return;
  }
  // blocks in turn on one set of threads, which meet at the block's
  // barrier before the next block reuses its shared memory
  blocks.emplace_back(new EmuBlock((int)block, smem));
  for (long t = 0; t < block; ++t)
    ts.emplace_back([&, t] {
      emu_block = blocks[0].get();
      threadIdx = dim3((unsigned)t);
      for (long b = 0; b < grid; ++b) {
        blockIdx = dim3((unsigned)b);
        f();
        emu_block->bar.arrive_and_wait();
      }
    });
  for (auto& th : ts) th.join();
}
#define emu_launch(grid, block, smem, f) \
  emu_run((long)(grid), (long)(block), (size_t)(smem), false, f)

template <class... A, size_t... I>
inline void emu_call(void (*k)(A...), void** args, std::index_sequence<I...>) {
  k(*static_cast<std::remove_reference_t<A>*>(args[I])...);
}
template <class... A>
inline int emu_launch_cooperative(void (*k)(A...), int threads, size_t smem, void** args,
                                  cudaStream_t) {
  int sms, per_sm;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, threads, smem);
  emu_run((long)per_sm * sms, threads, smem, true,
          [&] { emu_call(k, args, std::index_sequence_for<A...>{}); });
  return cudaGetLastError();
}
