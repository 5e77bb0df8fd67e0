// K1: integer-corner window extraction, (Hp, Wp) f32 + (N, 2) i32 -> (N, Sh, Sw).
//
// Replaces the TPU kernel patch_pallas._make_kernel_int
// (stereo_visual_odometry_tpu/ops/patch_pallas.py:88-115, pallas_call at
// :137), which copies img_pad[r:r+S, c:c+S] for N corners with an aligned
// (8, 128)-tiled VMEM block load and two rotates per point. The port also
// uses it for the XLA tracker's search windows (lk._slice_windows), which
// are (Sh, Sw) where a pyramid level is smaller than the square window.
//
// What bounds it on Hopper: bytes. It does no arithmetic; each call reads
// about N*Sh*Sw*4 B of image (the windows overlap little) and writes the
// same again, 2*N*Sh*Sw*4 B in all: 4.7 MB at N=1024, S=24. The design
// therefore only has to keep accesses coalesced:
//   * a block owns ppb consecutive points (one point for Sh*Sw >= 256,
//     several for the 3x3 neighbourhoods) and walks their ppb*Sh*Sw outputs
//     in flat row-major order, so consecutive threads write consecutive addresses
//     and read consecutive columns of one image row;
//   * the corner is loaded by every thread of its point (one L1 line);
//   * the image is read through the read-only path (__ldg).
// No tiling, shared memory or TMA: a window is a few hundred floats, and
// nothing is reused across points.
//
// Contract (the JAX one): corners are pre-clipped to [0, Hp-Sh] x [0, Wp-Sw].
// The kernel clamps them again, exactly as the wrapper's plain version does,
// so both agree for any input. It launches on the caller's stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void extract_windows_int_kernel(const float* __restrict__ img,
                                           int hp, int wp,
                                           const int32_t* __restrict__ corners,
                                           int n, int Sh, int Sw, int ppb,
                                           float* __restrict__ out) {
  const int first = blockIdx.x * ppb;
  const int npts = min(ppb, n - first);
  const int ss = Sh * Sw;
  const int total = npts * ss;
  float* dst = out + static_cast<size_t>(first) * ss;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int p = e / ss;
    const int rem = e - p * ss;
    const int r = rem / Sw;
    const int c = rem - r * Sw;
    const int k = first + p;
    const int row = min(max(__ldg(corners + 2 * k), 0), hp - Sh);
    const int col = min(max(__ldg(corners + 2 * k + 1), 0), wp - Sw);
    dst[e] = __ldg(img + static_cast<size_t>(row + r) * wp + (col + c));
  }
}

}  // namespace

extern "C" int svo_extract_windows_int(const float* img, int hp, int wp,
                                       const int32_t* corners, int n, int Sh,
                                       int Sw, float* out, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  constexpr int kThreads = 256;
  const int ss = Sh * Sw;
  const int ppb = ss >= kThreads ? 1 : (kThreads + ss - 1) / ss;
  const int blocks = (n + ppb - 1) / ppb;
  extract_windows_int_kernel<<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      img, hp, wp, corners, n, Sh, Sw, ppb, out);
  return static_cast<int>(cudaGetLastError());
}
