// K2: bilinear patch extraction at float centres,
// (Hp, Wp) f32 edge-padded image + (N, 2) f32 [x, y] centres -> (N, P, P) f32.
//
// Replaces the TPU kernel patch_pallas._make_kernel
// (stereo_visual_odometry_tpu/ops/patch_pallas.py:46-85, pallas_call at :199,
// reached through extract_patches_pallas :186), which loads an aligned
// (8, 128)-tiled VMEM block per point, rotates it into place and blends
// four shifted views of a (P+1)^2 window.
//
// What it computes, per centre (x, y) and with r = (P-1)/2:
//   corner   (ty, tx) = (y + pad - r, x + pad - r)            (float32)
//   integer  (iy, ix) = floor(corner), clipped to [0, Hp-P-1] x [0, Wp-P-1]
//   fraction (fy, fx) = corner - (iy, ix)                     (one per patch)
//   out[i][j] = a(1-fy)(1-fx) + b(1-fy)fx + c fy(1-fx) + d fy fx
// with a, b, c, d = img[iy+i][ix+j], img[iy+i][ix+j+1], img[iy+i+1][ix+j],
// img[iy+i+1][ix+j+1], evaluated as
//   fma(d fy, fx, fma(c fy, 1-fx, fma(a (1-fy), 1-fx, b (1-fy) fx)))
// — the JAX kernel's expression with the products fused into the running
// sum as XLA contracts it (the JAX package's interpret mode); the plain
// version, extract_patches_reference, emulates the same fmas exactly.
//
// What bounds it on Hopper: bytes. Each output costs 11 flops against 4 B
// written and ~4 B of window read; on the ORB path (P = 39, N = 445..124)
// a call moves a few MB and does a few MFLOP. The design keeps the accesses
// coalesced and the rounding that of the plain version:
//   * a block owns ppb consecutive patches (one for P >= 16) and walks their
//     ppb*P*P outputs in flat row-major order, so consecutive threads write
//     consecutive addresses and read consecutive columns of the window;
//   * every thread of a patch recomputes its corner and (fy, fx) from the
//     centre (one L1 line, a handful of flops) instead of a shared-memory
//     broadcast and a barrier;
//   * the image is read through the read-only path (__ldg); the four taps of
//     neighbouring outputs overlap, so L1 serves most of them;
//   * the blend is written with __fmul_rn / __fmaf_rn in the plain version's
//     order, so nvcc can neither contract nor split anything: the kernel
//     equals the plain version bit for bit.
// No tiling, shared memory or TMA: a window is 1600 floats, and windows of
// different patches are read by different blocks.
//
// The clip bounds use the unaligned extents (the JAX wrapper pads Hp to 8 and
// Wp to 128 for Mosaic); they differ from JAX's only for centres more than
// 2 px outside the image, which no caller produces. Launches on the caller's
// stream, allocates nothing, does not synchronise, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void extract_patches_kernel(const float* __restrict__ img,
                                       int hp, int wp,
                                       const float* __restrict__ centers,
                                       int n, int P, float pad, int ppb,
                                       float* __restrict__ out) {
  const int first = blockIdx.x * ppb;
  const int npts = min(ppb, n - first);
  const int pp = P * P;
  const int total = npts * pp;
  const float r = 0.5f * static_cast<float>(P - 1);
  float* dst = out + static_cast<size_t>(first) * pp;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int p = e / pp;
    const int rem = e - p * pp;
    const int i = rem / P;
    const int j = rem - i * P;
    const int k = first + p;
    const float ty = __fsub_rn(__fadd_rn(__ldg(centers + 2 * k + 1), pad), r);
    const float tx = __fsub_rn(__fadd_rn(__ldg(centers + 2 * k), pad), r);
    const int iy = min(max(static_cast<int>(floorf(ty)), 0), hp - P - 1);
    const int ix = min(max(static_cast<int>(floorf(tx)), 0), wp - P - 1);
    const float fy = __fsub_rn(ty, static_cast<float>(iy));
    const float fx = __fsub_rn(tx, static_cast<float>(ix));
    const float gy = __fsub_rn(1.0f, fy);
    const float gx = __fsub_rn(1.0f, fx);
    const float* src = img + static_cast<size_t>(iy + i) * wp + (ix + j);
    const float a = __ldg(src);
    const float b = __ldg(src + 1);
    const float c = __ldg(src + wp);
    const float d = __ldg(src + wp + 1);
    float v = __fmul_rn(__fmul_rn(b, gy), fx);
    v = __fmaf_rn(__fmul_rn(a, gy), gx, v);
    v = __fmaf_rn(__fmul_rn(c, fy), gx, v);
    v = __fmaf_rn(__fmul_rn(d, fy), fx, v);
    dst[e] = v;
  }
}

}  // namespace

extern "C" int svo_extract_patches(const float* img, int hp, int wp,
                                   const float* centers, int n, int P, int pad,
                                   float* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  constexpr int kThreads = 256;
  const int pp = P * P;
  const int ppb = pp >= kThreads ? 1 : (kThreads + pp - 1) / pp;
  const int blocks = (n + ppb - 1) / ppb;
  extract_patches_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      img, hp, wp, centers, n, P, static_cast<float>(pad), ppb, out);
  return static_cast<int>(cudaGetLastError());
}
