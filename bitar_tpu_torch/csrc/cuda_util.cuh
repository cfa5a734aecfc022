// What every CUDA kernel library of the port shares: the shared-memory
// opt-in and the message of the CUDA error code a launch function returns.
// Each library (one .cu) includes this header once.

#pragma once

#include <cuda_runtime.h>

namespace bt {

constexpr int kSmemMax = 232448;       // H100 opt-in shared memory per block
constexpr int kSmemDefault = 48 * 1024;

// Lets `kernel` take `bytes` of dynamic shared memory on the current device
// (needed above 48 KiB); returns the CUDA error code.
template <typename Kernel>
inline cudaError_t smem_opt_in(Kernel kernel, int bytes) {
  if (bytes <= kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace bt

extern "C" const char* bt_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
