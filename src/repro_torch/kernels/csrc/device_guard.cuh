// Device guard of the port's C entry points: each takes the index of the
// device its tensors live on and makes it current for the launch only when
// it is not already, so the Python side needs no guard of its own per launch.

#pragma once

#include <cuda_runtime.h>

struct DeviceGuard {
  int prev = -1;
  explicit DeviceGuard(int device) {
    int cur = -1;
    cudaGetDevice(&cur);
    if (cur != device && cudaSetDevice(device) == cudaSuccess) prev = cur;
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
};
