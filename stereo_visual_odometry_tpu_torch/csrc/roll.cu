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
// no arithmetic); at the probe's sizes (<= 128 KB) the launch itself. Where
// the rows are whole 16-byte groups (cols % 4 == 0, both pointers 16-byte
// aligned), roll4_kernel gives a thread four consecutive outputs and one
// 16-byte store, read with one 16-byte load where the source is aligned too
// (axis 0, or an amount that is a multiple of 4 on axis 1) and with four
// loads otherwise: a quarter of the threads and memory instructions of
// roll_kernel, one thread per element, which takes any other shape
// (PERF.md: 0.05-0.07 us less per call in a CUDA graph at (128, 256), from
// the 1.70 us of the scalar kernel towards a one-row call's 1.50).
// Consecutive threads cover consecutive columns, so writes and reads are
// coalesced (an axis-1 roll splits a row's reads at the wrap point). Each
// thread reads the amount itself from the (1, 1) int32 device tensor, so the
// host never waits for it. Launches on the caller's stream, allocates
// nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "patch_common.cuh"

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

// Four consecutive outputs per thread (see the note above).
__global__ void __launch_bounds__(kThreads)
roll4_kernel(const float* __restrict__ x, int rows, int cols,
             const int32_t* __restrict__ amt, int axis, float* __restrict__ out) {
  const int64_t e = 4 * (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x);
  if (e >= static_cast<int64_t>(rows) * cols) return;
  const int size = axis == 0 ? rows : cols;
  int a = __ldg(amt) % size;
  if (a < 0) a += size;
  const int i = static_cast<int>(e / cols);
  const int j = static_cast<int>(e - static_cast<int64_t>(i) * cols);
  float4 v;
  if (axis == 0) {
    const int si = i + a >= rows ? i + a - rows : i + a;
    v = __ldg(reinterpret_cast<const float4*>(x + static_cast<int64_t>(si) * cols + j));
  } else if ((a & 3) == 0) {
    const int sj = j + a >= cols ? j + a - cols : j + a;
    v = __ldg(reinterpret_cast<const float4*>(x + static_cast<int64_t>(i) * cols + sj));
  } else {
    const float* row = x + static_cast<int64_t>(i) * cols;
    float t[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int sj = j + u + a >= cols ? j + u + a - cols : j + u + a;
      t[u] = __ldg(row + sj);
    }
    v = make_float4(t[0], t[1], t[2], t[3]);
  }
  reinterpret_cast<float4*>(out)[e / 4] = v;
}

}  // namespace

extern "C" int svo_roll(const float* x, int rows, int cols, const int32_t* amt, int axis,
                        float* out, int device, void* stream) {
  if (rows <= 0 || cols <= 0 || (axis != 0 && axis != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  svo::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const int64_t total = static_cast<int64_t>(rows) * cols;
  const bool vec = cols % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t threads = vec ? total / 4 : total;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (vec)
    roll4_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(x, rows, cols, amt, axis, out);
  else
    roll_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(x, rows, cols, amt, axis, out);
  return static_cast<int>(cudaGetLastError());
}
