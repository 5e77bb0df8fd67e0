// K1: integer-corner window extraction, (Hp, Wp) f32 + (N, 2) i32 -> (N, Sh, Sw).
//
// Replaces the TPU kernel patch_pallas._make_kernel_int
// (stereo_visual_odometry_tpu/ops/patch_pallas.py:88-115, pallas_call at
// :137), which copies img_pad[r:r+S, c:c+S] for N corners with an aligned
// (8, 128)-tiled VMEM block load and two rotates per point. The port also
// uses it for the XLA tracker's search windows (lk._slice_windows), which
// are (Sh, Sw) where a pyramid level is smaller than the square window.
//
// What bounds it on Hopper: bytes. It does no arithmetic; a call reads the
// distinct pixels its windows cover and writes N*Sh*Sw floats: at N = 1024,
// S = 24, about 3.8 MB in all, 1.14 us at 3.35 TB/s. At that size the launch
// and the latency of a few dependent loads per thread are what is left, so
// the design keeps every lane busy and the instruction count per element low:
//   * a fixed group of 2^g lanes per point, 256/2^g points per 256-thread
//     CTA. The host picks the largest group (the fewest serial steps per
//     lane) that keeps at least 3/4 of its lanes working: S = 24 takes two
//     warps (3 steps), S = 22 four (1 step), the 3x3 neighbourhoods 4 lanes
//     (8 points per warp), 64x64 the whole CTA, 36x36 half of it;
//   * each lane loads and clamps its point's corner once (the group reads
//     the same 8 bytes), then walks its elements with running row and column
//     counters (svo::Walk): no division per element;
//   * where Sh*Sw is a multiple of 4 (576, 484, 4096, 1296) every window
//     starts 16-byte aligned, and a lane moves four consecutive elements per
//     step: four 4-byte reads (a row break inside the four is a counter
//     carry) and one float4 store. Otherwise (3x3, 5x7) one element per step.
// Nothing is staged in shared memory: a copy uses each pixel it reads once,
// and the windows of one call barely overlap, so a trip through shared
// memory would add a store, a load and a barrier and save no device read.
//
// Contract (the JAX one): corners are pre-clipped to [0, Hp-Sh] x [0, Wp-Sw].
// The kernel clamps them again, exactly as the wrapper's plain version does,
// so both agree for any input. It launches on the caller's stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().
//
// The sequence axis (svo_extract_windows_int_batched): B images of
// (Hp, Wp), B x N corners and B x N windows, each contiguous, in one launch
// with gridDim.y = B; block (x, y) offsets the image, corner and output
// pointers by sequence y and runs the body above unchanged. The clamps stay
// per image, so no window reads a neighbouring sequence. This replaces the
// JAX batch rule (patch_pallas.py:147-163), which stacks the B images into
// one (B*Hp, Wp) image and offsets each corner's row by b*Hp: the stack is
// a copy Pallas needs for its one image operand; a pointer offset per
// block copies nothing and is exact. svo_extract_windows_int is the batched
// launch with B = 1, under its own C contract.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "patch_common.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kQuads>
__global__ void __launch_bounds__(kThreads)
extract_windows_int_kernel(const float* __restrict__ img, int hp, int wp,
                           const int32_t* __restrict__ corners, int n, int Sh, int Sw,
                           int log2_group, float* __restrict__ out) {
  const size_t seq = blockIdx.y;
  img += seq * hp * wp;
  corners += seq * n * 2;
  out += seq * n * Sh * Sw;
  const int k = blockIdx.x * (kThreads >> log2_group) + (threadIdx.x >> log2_group);
  if (k >= n) return;
  const int lane = threadIdx.x & ((1 << log2_group) - 1);
  const int row = min(max(__ldg(corners + 2 * k), 0), hp - Sh);
  const int col = min(max(__ldg(corners + 2 * k + 1), 0), wp - Sw);
  const float* src = img + static_cast<size_t>(row) * wp + col;
  const int ss = Sh * Sw;
  float* dst = out + static_cast<size_t>(k) * ss;
  constexpr int kPer = kQuads ? 4 : 1;
  const int step = kPer << log2_group;
  svo::Walk at(lane * kPer, step, Sh, Sw);
#pragma unroll 4
  for (int e = lane * kPer; e < ss; e += step, at.advance()) {
    if (kQuads) {
      float v[4];
      int i = at.i, j = at.j;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        v[t] = __ldg(src + i * wp + j);
        if (++j == Sw) {
          j = 0;
          ++i;
        }
      }
      *reinterpret_cast<float4*>(dst + e) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      dst[e] = __ldg(src + at.i * wp + at.j);
    }
  }
}

// log2 of the lanes per point for a window of `units` lane steps of work
// (elements, or quads of them): the largest group, 4 to 256 lanes, whose
// lanes are at least 3/4 busy; 4 lanes where none is.
int group_log2(int units) {
  for (int lg = 8; lg > 2; --lg) {
    const int group = 1 << lg;
    const long long slots = static_cast<long long>((units + group - 1) / group) * group;
    if (4LL * units >= 3 * slots) return lg;
  }
  return 2;
}

}  // namespace

extern "C" int svo_extract_windows_int_batched(const float* img, int hp, int wp,
                                               const int32_t* corners, int n, int batch,
                                               int Sh, int Sw, float* out, int device,
                                               void* stream) {
  if (n == 0 || batch == 0) return 0;
  if (Sh < 1 || Sw < 1 || Sh > hp || Sw > wp || batch < 0 || batch > 65535 ||
      static_cast<long long>(hp) * wp > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  svo::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const int ss = Sh * Sw;
  const bool quads = ss % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int lg = group_log2(quads ? ss / 4 : ss);
  const int per_cta = kThreads >> lg;
  const dim3 blocks((n + per_cta - 1) / per_cta, batch);
  const auto s = static_cast<cudaStream_t>(stream);
  if (quads) {
    extract_windows_int_kernel<true><<<blocks, kThreads, 0, s>>>(
        img, hp, wp, corners, n, Sh, Sw, lg, out);
  } else {
    extract_windows_int_kernel<false><<<blocks, kThreads, 0, s>>>(
        img, hp, wp, corners, n, Sh, Sw, lg, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int svo_extract_windows_int(const float* img, int hp, int wp,
                                       const int32_t* corners, int n, int Sh,
                                       int Sw, float* out, int device,
                                       void* stream) {
  return svo_extract_windows_int_batched(img, hp, wp, corners, n, 1, Sh, Sw, out, device,
                                         stream);
}
