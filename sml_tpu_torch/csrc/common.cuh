// Helpers shared by the kernel sources.
#pragma once

#include <atomic>
#include <cuda_runtime.h>
#include <stdint.h>

// Largest dynamic shared memory one block may opt in to on sm_90 (227 KB).
constexpr size_t MAX_SMEM = 232448;

// Opt `kernel` in to MAX_SMEM bytes of dynamic shared memory on the current
// device. The attribute belongs to the function and the device, so it is set
// once per device: `ready` (one per kernel instantiation) keeps a bit for
// each device already done, and later launches make no driver call for it.
// The opt-in is a ceiling; each launch still asks for only what it uses.
template <typename Kernel>
cudaError_t allow_max_smem(Kernel kernel, std::atomic<uint64_t>& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit != 0 && (ready.load(std::memory_order_relaxed) & bit) != 0)
    return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
  if (err == cudaSuccess) ready.fetch_or(bit, std::memory_order_relaxed);
  return err;
}
