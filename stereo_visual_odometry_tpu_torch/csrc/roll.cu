// K7: out = roll(x, -amt, axis) of a (rows, cols) float32 array, with the
// amount read from device memory.
//
// Replaces the TPU kernel probe_roll.make (scripts/probe_roll.py:12-25,
// pallas_call at :18): `pltpu.roll(x, -amt_ref[0, 0], axis)` with the amount
// in scalar memory, the probe of Mosaic's dynamic sublane/lane rotate. So
// out[i, j] = x[(i + a) mod rows, j] (axis 0) or x[i, (j + a) mod cols]
// (axis 1), where a is the amount taken modulo the axis length with
// Python's sign rule (np.roll's semantics for negative amounts and amounts
// >= the length).
//
// What bounds it on Hopper: bytes (each element read once and written once,
// no arithmetic). One thread per output element, consecutive threads on
// consecutive columns, so both the writes and the reads are coalesced (an
// axis-1 roll splits a row's reads at the wrap point, nothing more). Each
// thread reads the amount itself from the (1, 1) int32 device tensor, so the
// host never waits for it. Launches on the caller's stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
roll_kernel(const float* __restrict__ x, int rows, int cols,
            const int32_t* __restrict__ amt, int axis, float* __restrict__ out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= static_cast<int64_t>(rows) * cols) return;
  const int size = axis == 0 ? rows : cols;
  int a = __ldg(amt) % size;
  if (a < 0) a += size;
  const int i = static_cast<int>(e / cols);
  const int j = static_cast<int>(e - static_cast<int64_t>(i) * cols);
  int si = i, sj = j;
  if (axis == 0) {
    si = i + a >= rows ? i + a - rows : i + a;
  } else {
    sj = j + a >= cols ? j + a - cols : j + a;
  }
  out[e] = __ldg(x + static_cast<int64_t>(si) * cols + sj);
}

}  // namespace

extern "C" int svo_roll(const float* x, int rows, int cols, const int32_t* amt, int axis,
                        float* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0 || cols <= 0 || (axis != 0 && axis != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = static_cast<int64_t>(rows) * cols;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  roll_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(x, rows, cols, amt, axis, out);
  return static_cast<int>(cudaGetLastError());
}
