// The cooperative launch of a persistent kernel, shared by K8/K9
// (shoot2d.cu) and K16 (fft_whole.cu): as many blocks of `threads` as the
// card holds at once (occupancy x SMs), or fewer, so that every block is
// resident and cooperative_groups::this_grid().sync() may separate the
// kernel's phases.
// The shared-memory attribute and the occupancy are asked of the runtime
// once per (kernel, threads, shared memory, device) and kept, so that a
// launch costs one cudaGetDevice besides the launch itself.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace lagomorph {

// the grid of a cooperative launch of `kernel` (blocks), after setting its
// dynamic shared memory to `smem` bytes
static inline int cooperative_blocks(const void* kernel, int threads, size_t smem, int* blocks) {
  struct Entry {
    const void* kernel;
    int threads;
    size_t smem;
    int dev, blocks;
  };
  constexpr int kEntries = 64;
  static std::mutex mu;
  static Entry cache[kEntries];
  static int used = 0;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  // the attribute only grows, so that it stays valid for every entry kept
  size_t attr = smem;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < used; ++i) {
      const Entry& e = cache[i];
      if (e.kernel != kernel || e.dev != dev) continue;
      if (e.threads == threads && e.smem == smem) {
        *blocks = e.blocks;
        return (int)cudaSuccess;
      }
      if (e.smem > attr) attr = e.smem;
    }
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)attr);
  if (err != cudaSuccess) return (int)err;
  int sms, per_sm;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  *blocks = per_sm * sms;
  std::lock_guard<std::mutex> lock(mu);
  if (used < kEntries) cache[used++] = Entry{kernel, threads, smem, dev, *blocks};
  return (int)cudaSuccess;
}

// launch `kernel` on that grid, or on max_blocks if that is fewer (> 0)
static inline int launch_cooperative(const void* kernel, int threads, size_t smem,
                                     void** args, cudaStream_t stream, int max_blocks = 0) {
  int blocks;
  int err = cooperative_blocks(kernel, threads, smem, &blocks);
  if (err != (int)cudaSuccess) return err;
  if (max_blocks > 0 && max_blocks < blocks) blocks = max_blocks;
  err = (int)cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(threads), args, smem, stream);
  if (err != (int)cudaSuccess) return err;
  return (int)cudaGetLastError();
}

}  // namespace lagomorph
