// The hold kernel of the port's kernel timer (utils/timing.py
// kernel_time_ms): one thread that spins on a flag in mapped, pinned host
// memory.  Launched first on a stream, it holds every launch queued behind
// it until the host sets the flag, so the device then runs them back to
// back, without the host's gaps between launches.  It gives up after a
// bound on %globaltimer and says so in a second flag: a timed function that
// waits on the host (a synchronize) would otherwise wait forever on a stream
// that waits on the host.  Built for sm_90a like the port's kernels; it is
// a timing tool, no TPU kernel's counterpart.

#include <cstdint>

#include "cuda_util.cuh"

namespace {

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// flags[0]: the host's release (0 holds); flags[1]: 1 once the hold gave up.
__global__ void hold_kernel(volatile int32_t* flags, unsigned long long timeout_ns) {
  const unsigned long long t0 = global_ns();
  while (flags[0] == 0) {
    if (global_ns() - t0 > timeout_ns) {
      flags[1] = 1;
      __threadfence_system();
      return;
    }
    __nanosleep(1000);
  }
}

}  // namespace

// Two int32 flags in pinned host memory that every device can map: the host
// pointer in *host, the device's in *dev.  Returns the CUDA error code.
extern "C" int bt_hold_alloc(void** host, void** dev) {
  void* h = nullptr;
  cudaError_t err = cudaHostAlloc(&h, 2 * sizeof(int32_t),
                                  cudaHostAllocMapped | cudaHostAllocPortable);
  if (err != cudaSuccess) return static_cast<int>(err);
  static_cast<int32_t*>(h)[0] = static_cast<int32_t*>(h)[1] = 0;
  err = cudaHostGetDevicePointer(dev, h, 0);
  if (err != cudaSuccess) {
    cudaFreeHost(h);
    return static_cast<int>(err);
  }
  *host = h;
  return 0;
}

// Clears both flags; call only while no hold kernel runs on them.
extern "C" void bt_hold_arm(void* host) {
  volatile int32_t* f = static_cast<volatile int32_t*>(host);
  f[0] = 0;
  f[1] = 0;
  __atomic_thread_fence(__ATOMIC_SEQ_CST);
}

// Releases the launches queued behind the hold.
extern "C" void bt_hold_release(void* host) {
  __atomic_thread_fence(__ATOMIC_SEQ_CST);
  static_cast<volatile int32_t*>(host)[0] = 1;
}

// 1 when the last hold gave up waiting for its release; read after the
// stream is synchronized.
extern "C" int bt_hold_gave_up(const void* host) {
  return static_cast<const volatile int32_t*>(host)[1];
}

// Launches the hold on `stream` of `device`: it returns once the host
// releases it or after `timeout_ns` of the device's global timer.
extern "C" int bt_hold_launch(void* dev_flags, unsigned long long timeout_ns, int device,
                              void* stream) {
  if (dev_flags == nullptr || device < 0) return static_cast<int>(cudaErrorInvalidValue);
  int previous = 0;
  cudaError_t err = bt::enter_device(device, &previous);
  if (err != cudaSuccess) return static_cast<int>(err);
  hold_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<volatile int32_t*>(dev_flags), timeout_ns);
  err = cudaGetLastError();
  if (previous != device) cudaSetDevice(previous);
  return static_cast<int>(err);
}
