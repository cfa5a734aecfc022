// What every CUDA kernel library of the port shares: the shared-memory
// opt-in, entering a launch's device, and the message of the CUDA error
// code a launch function returns.
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

// Makes `device` current for a launch; returns the CUDA error code and sets
// `previous` to restore afterwards.  A failure is returned, not left as the
// thread's last error for a later launch's cudaGetLastError to find.
inline cudaError_t enter_device(int device, int* previous) {
  cudaError_t err = cudaGetDevice(previous);
  if (err == cudaSuccess && *previous != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace bt

extern "C" const char* bt_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
