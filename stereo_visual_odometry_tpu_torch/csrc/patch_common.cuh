// Shared by the kernels of csrc/: a division-free walk over a row-major
// index (K1, K2, K3/K4), and the device switch of every C entry point.
#pragma once

#include <cuda_runtime.h>

namespace svo {

// Running coordinates (p, i, j) of a flat index into [.][rows][cols],
// advanced by a fixed step with two compares: a thread divides once, when it
// starts its walk, and never per element.
struct Walk {
  int p, i, j;
  int dp, di, dj;
  int rows, cols;

  __device__ Walk(int start, int step, int rows_, int cols_) : rows(rows_), cols(cols_) {
    const int plane = rows * cols;
    p = start / plane;
    const int rem = start - p * plane;
    i = rem / cols;
    j = rem - i * cols;
    dp = step / plane;
    const int drem = step - dp * plane;
    di = drem / cols;
    dj = drem - di * cols;
  }

  __device__ void advance() {
    j += dj;
    if (j >= cols) {
      j -= cols;
      ++i;
    }
    i += di;  // i <= rows - 1 + 1 + (rows - 1): one carry at most
    if (i >= rows) {
      i -= rows;
      ++p;
    }
    p += dp;
  }
};

// Makes `device` current for a launch only when it is not already, and gives
// the caller's device back afterwards.
class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    int current = 0;
    err_ = cudaGetDevice(&current);
    if (err_ == cudaSuccess && current != device) {
      err_ = cudaSetDevice(device);
      if (err_ == cudaSuccess) previous_ = current;
    }
  }
  ~DeviceGuard() {
    if (previous_ >= 0) cudaSetDevice(previous_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;
  cudaError_t error() const { return err_; }

 private:
  int previous_ = -1;
  cudaError_t err_ = cudaSuccess;
};

}  // namespace svo
