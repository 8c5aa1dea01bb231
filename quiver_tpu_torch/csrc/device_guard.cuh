// The kernel library's entry points run on the device their tensors live
// on and leave the caller's current device as they found it. The library
// links its own CUDA runtime, so the device is set here rather than
// inherited from the caller's; without the restore, a launch on card s
// would leave the calling thread on card s, and the caller's next
// allocation or stream taken without an index would land there.

#pragma once

#include <cuda_runtime.h>

namespace {

// Sets `device` current for the guard's scope and restores the caller's
// current device when the scope ends. `err` is the set's cudaError_t.
struct DeviceGuard {
  int prev = -1;
  cudaError_t err;
  explicit DeviceGuard(int device) {
    if (cudaGetDevice(&prev) != cudaSuccess) prev = -1;
    err = prev == device ? cudaSuccess : cudaSetDevice(device);
  }
  ~DeviceGuard() {
    int cur = -1;
    if (prev >= 0 && cudaGetDevice(&cur) == cudaSuccess && cur != prev) cudaSetDevice(prev);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
};

}  // namespace
