// K2: bilinear patch extraction at float centres, edge-replicated,
// (H, W) f32 image + (N, 2) f32 [x, y] centres -> (N, P, P) f32.
//
// Replaces the TPU kernel patch_pallas._make_kernel
// (stereo_visual_odometry_tpu/ops/patch_pallas.py:46-85, pallas_call at :199,
// reached through extract_patches_pallas :186), which loads an aligned
// (8, 128)-tiled VMEM block per point of an edge-padded image, rotates it
// into place and blends four shifted views of a (P+1)^2 window.
//
// What it computes, per centre (x, y), with pad = P/2 + 2, r = (P-1)/2 and
// the padded extents Hp = H + 2 pad, Wp = W + 2 pad:
//   corner   (ty, tx) = (y + pad - r, x + pad - r)            (float32)
//   integer  (iy, ix) = floor(corner), clipped to [0, Hp-P-1] x [0, Wp-P-1]
//   fraction (fy, fx) = corner - (iy, ix)                     (one per patch)
//   tap (u, v) of the window = img[clamp(iy+u-pad, 0, H-1)][clamp(ix+v-pad, 0, W-1)]
//   out[i][j] = fma(d fy, fx, fma(c fy, 1-fx, fma(a (1-fy), 1-fx, b (1-fy) fx)))
// with a, b, c, d the taps (i, j), (i, j+1), (i+1, j), (i+1, j+1). The
// clamped tap is the edge-padded image's pixel, so no padded copy is made;
// the blend is the JAX kernel's expression with the products fused into the
// running sum as XLA contracts it (the JAX package's interpret mode), written
// with __fmul_rn / __fmaf_rn so nvcc can neither contract nor split anything:
// the kernel equals the plain versions (patch.py) bit for bit.
//
// What bounds it on Hopper: bytes. Each output costs 11 flops against 4 B
// written and ~4 B of window read; on the ORB path (P = 39, N = 445..124) a
// call moves 1-4 MB, about 1.2 us at 3.35 TB/s, so the launch and the
// latency of the window loads are what is left. The design:
//   * a CTA of 256 threads owns ppb patches: kPatchesPerCta, or as many as
//     fit in 48 KB of shared memory, at least 1 (P up to 127 takes the opt-in
//     shared memory). kPatchesPerCta = 2 was the fastest of 1, 2, 4 and 8 in
//     a CUDA graph at P = 39, N = 445 on the H100 (fewer patches per CTA give
//     more CTAs to fill 132 SMs). One thread per patch computes its corner
//     and (fy, fx, 1-fy, 1-fx) once, into shared memory;
//   * the CTA stages each (P+1)^2 window in shared memory with 4-byte
//     cp.async copies, consecutive threads on consecutive columns, then one
//     barrier: each pixel of a window leaves L2 once, not four times;
//   * the blend walks the CTA's outputs in flat row-major order (svo::Walk:
//     running counters, no division per element), consecutive threads on
//     consecutive outputs, so each tap load of a warp reads consecutive
//     words (no bank conflict but at a row break) and the 4-byte stores of a
//     warp fill one 128-byte line. Four outputs
//     per thread as float4 stores would put a warp's taps 4 words apart
//     (4-way bank conflicts on ~10 loads per 4 outputs) to save 3 of 4
//     store instructions that are already whole lines.
// Launches on the caller's stream, allocates nothing, does not synchronise,
// returns cudaGetLastError().
//
// The sequence axis (svo_extract_patches_batched): B images of (H, W), B x N
// centres and B x N patches, each contiguous, in one launch with
// gridDim.y = B; block (x, y) offsets the image, centre and output pointers
// by sequence y and runs the body above unchanged, with its taps clamped to
// its own image. The JAX package has no batch rule for this kernel (Pallas
// batches it with a grid axis); the vmapped ORB step reaches it, so it gets
// the same axis as K1. svo_extract_patches is the batched launch with B = 1.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include <algorithm>

#include "patch_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kPatchesPerCta = 2;  // at most; fewer where their windows pass 48 KB
static_assert(kPatchesPerCta <= kThreads, "one thread sets up each patch");
constexpr size_t kPerPatch = sizeof(float4) + sizeof(int2);  // (fy, fx, gy, gx), corner

__device__ __forceinline__ void copy_async4(float* smem_dst, const float* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}

__global__ void __launch_bounds__(kThreads)
extract_patches_kernel(const float* __restrict__ img, int h, int w,
                       const float* __restrict__ centers, int n, int P, int pad,
                       int ppb, float* __restrict__ out) {
  const size_t seq = blockIdx.y;
  img += seq * h * w;
  centers += seq * n * 2;
  out += seq * n * P * P;
  extern __shared__ float4 smem[];
  float4* frac = smem;                                    // per patch: fy, fx, 1-fy, 1-fx
  int2* corner = reinterpret_cast<int2*>(smem + ppb);     // per patch: first tap, unpadded
  float* win = reinterpret_cast<float*>(corner + ppb);    // ppb windows of (P+1)^2
  const int first = blockIdx.x * ppb;
  const int npts = min(ppb, n - first);
  const int side = P + 1;
  const int area = side * side;
  if (threadIdx.x < npts) {
    const int k = first + threadIdx.x;
    const float r = 0.5f * static_cast<float>(P - 1);
    const float fpad = static_cast<float>(pad);
    const float ty = __fsub_rn(__fadd_rn(__ldg(centers + 2 * k + 1), fpad), r);
    const float tx = __fsub_rn(__fadd_rn(__ldg(centers + 2 * k), fpad), r);
    const int iy = min(max(static_cast<int>(floorf(ty)), 0), h + 2 * pad - P - 1);
    const int ix = min(max(static_cast<int>(floorf(tx)), 0), w + 2 * pad - P - 1);
    const float fy = __fsub_rn(ty, static_cast<float>(iy));
    const float fx = __fsub_rn(tx, static_cast<float>(ix));
    frac[threadIdx.x] = make_float4(fy, fx, __fsub_rn(1.0f, fy), __fsub_rn(1.0f, fx));
    corner[threadIdx.x] = make_int2(iy - pad, ix - pad);
  }
  __syncthreads();

  svo::Walk at(threadIdx.x, kThreads, side, side);
  for (int e = threadIdx.x; e < npts * area; e += kThreads, at.advance()) {
    const int2 c0 = corner[at.p];
    const int y = min(max(c0.x + at.i, 0), h - 1);
    const int x = min(max(c0.y + at.j, 0), w - 1);
    copy_async4(win + e, img + static_cast<size_t>(y) * w + x);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  float* dst = out + static_cast<size_t>(first) * P * P;
  svo::Walk o(threadIdx.x, kThreads, P, P);
  for (int e = threadIdx.x; e < npts * P * P; e += kThreads, o.advance()) {
    const float4 f = frac[o.p];
    const float* s = win + o.p * area + o.i * side + o.j;
    float v = __fmul_rn(__fmul_rn(s[1], f.z), f.y);
    v = __fmaf_rn(__fmul_rn(s[0], f.z), f.w, v);
    v = __fmaf_rn(__fmul_rn(s[side], f.x), f.w, v);
    v = __fmaf_rn(__fmul_rn(s[side + 1], f.x), f.y, v);
    dst[e] = v;
  }
}

}  // namespace

extern "C" int svo_extract_patches_batched(const float* img, int h, int w,
                                           const float* centers, int n, int batch, int P,
                                           int pad, float* out, int device, void* stream) {
  if (n == 0 || batch == 0) return 0;
  if (P < 1 || pad < 0 || h < 1 || w < 1 || h + 2 * pad < P + 1 ||
      w + 2 * pad < P + 1 || batch < 0 || batch > 65535 ||
      static_cast<long long>(h) * w > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  svo::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const size_t per_patch = kPerPatch + sizeof(float) * static_cast<size_t>(P + 1) * (P + 1);
  const int ppb = static_cast<int>(
      std::max<size_t>(1, std::min<size_t>(kPatchesPerCta, kDefaultSmem / per_patch)));
  const size_t smem = ppb * per_patch;
  if (smem > kDefaultSmem) {
    int optin = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(extract_patches_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 blocks((n + ppb - 1) / ppb, batch);
  extract_patches_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      img, h, w, centers, n, P, pad, ppb, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int svo_extract_patches(const float* img, int h, int w, const float* centers,
                                   int n, int P, int pad, float* out, int device,
                                   void* stream) {
  return svo_extract_patches_batched(img, h, w, centers, n, 1, P, pad, out, device, stream);
}
