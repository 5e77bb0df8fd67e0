// K3 and K4: one pyramid level of Lucas-Kanade for N points on edge-padded
// (Hp, Wp) float32 level images, one CTA per point, the whole level call in
// one kernel.
//
// Replace the TPU kernels
//   K3  lk_pallas_cell._make_kernel (stereo_visual_odometry_tpu/ops/
//       lk_pallas_cell.py:48-198, pallas_call at :223), entry svo_lk_level_cell;
//   K4  lk_pallas._make_kernel (stereo_visual_odometry_tpu/ops/lk_pallas.py:
//       46-157, pallas_call at :195), entry svo_lk_level_v1.
// Both compute, per active point: the template T and its central-difference
// gradients Ix, Iy from a (win+3)^2 window of `prev` blended at the point's
// fraction, the 2x2 normal matrix, the min-eigenvalue gate and its inverse;
// then iterate the flow delta from the incoming guess until |delta| <= eps or
// `iters` iterations. K4 reloads and re-blends a (win+1)^2 window of `next`
// on every iteration and takes 2 dot products. K3 reloads only when the
// point enters another pixel cell: with the integer corner fixed, the
// right-hand side is bilinear in the fraction, so 8 dots per cell (the four
// corner sub-patches a..d against Ix and Iy) feed a scalar inner loop.
//
// The kernel also does what the JAX wrappers do after their pallas_call
// (lk_pallas_cell.py:294-309, where XLA fuses it into the same jit): it
// writes flow = guess + delta and ok = gate && |delta_x|, |delta_y| <=
// search_radius (the same float add and compares as ops/lk_v1.finish, so
// the outputs are bit for bit those of the kernel delta finished in
// PyTorch), reads `active` as the caller's (N,) bool bytes (null: all
// active), and writes each point's iterations and reloads only when `stats`
// is not null. A level call is one kernel node: eager, it saves six small
// launches; in a CUDA graph, six nodes of ~1.5 us each.
//
// What bounds it on Hopper: neither bytes nor flops. At N=1024 on a
// 384x1280 level a call moves ~3 MB of distinct pixels (~1 us at 3.35 TB/s)
// and does ~50 MFLOP; the 1024 CTAs fit the 132 SMs in one wave, so a call
// lasts as long as its slowest point's chain of dependent steps: up to
// `iters` window reads, each followed by a block reduction. What the design
// does about each link of that chain:
//   * staged regions: each CTA issues one round of 4-byte cp.async copies
//     for both the (win+3)^2 template window of `prev` and a region of
//     `next` of (win+1+2*kMargin)^2 pixels around the window at the guess,
//     so the two device-memory latencies overlap and are paid once. A later
//     window inside the region (most of them: PERF.md) is read in place from
//     shared memory: no copy and no barrier of its own. A window that leaves
//     the region is read from device memory into the template's buffer, as
//     before; the pixels are the same either way, so are the values;
//   * kMargin = 7 (a 36^2 region, 5.2 KB at win 21): on the first bench
//     frames it serves 94-96% of the reloads (4: 89-90%, 0: 26-36%), and
//     there a level call took 37.5-39.3 us against 39.2-41.9 at 4 on the
//     H100; the two synthetic operating points, whose reloads 4 already
//     serves, lose 0.1-0.5 us to the larger copy (PERF.md). 14.6 KB per CTA
//     keeps the 8 CTAs per SM that one wave of 1024 points needs;
//   * kThreads = 64: two warps per point. Against 128 the element loops are
//     longer but every reduction and barrier is cheaper, and the chain is
//     made of those (128: ~1.35x, 256: ~2x the time; 32 mixed, PERF.md);
//   * every element loop walks its (i, j) with svo::Walk (running counters,
//     no division per element), from a start computed once per thread;
//   * block_sum: every thread leaves with the same totals, summed over the
//     warps in one fixed order, so each loop decision is the same in every
//     thread and every __syncthreads() is reached by the whole CTA. It keeps
//     its trailing barrier: two slots of `red` used in turns (one barrier
//     per reduction) measured no faster at two warps;
//   * K3's inner iteration is ~20 scalar ops, computed redundantly by every
//     thread from those shared totals, with no barrier;
//   * the Mosaic shapes of the TPU kernels (aligned (8, 128) block loads plus
//     two rolls, BLK=8 points per program, the stacked-image batch rule) are
//     not the op and are dropped: callers clip every corner in bounds, so a
//     window is a plain strided read.
// IEEE floorf/sqrtf/division (no fast math): the gates compare against
// thresholds. The blend and the scalar step keep the JAX kernels' float
// order; only the order of the block sums differs. Contract as the JAX
// kernels: corners clipped against the padded extents; inactive points
// return delta 0 (flow = guess), ok 0 at once. No convergence gate: a point
// still iterating after `iters` keeps its ok. Launches on the caller's
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "patch_common.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSums = 8;
constexpr int kMargin = 7;  // px of `next` staged around the window at the guess

// Sum K per-thread values over the CTA. Every thread returns with the same
// totals: lane 0 of each warp publishes its warp's sum, and every thread adds
// the warps' sums in the same order. The trailing barrier lets the next
// reduction reuse `red`.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red) {
  float* r = red;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float x = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    if (lane == 0) r[warp * kMaxSums + k] = x;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = r[k];
    for (int w = 1; w < kWarps; ++w) s += r[w * kMaxSums + k];
    v[k] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ int floor_clip(float x, int hi) {
  return min(max(__float2int_rd(x), 0), hi);
}

__device__ __forceinline__ void copy_async4(float* smem_dst, const float* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}

// Issue the copies of img[r0:r0+rows, c0:c0+cols] into dst (row-major,
// `cols` wide); the caller waits for them.
__device__ __forceinline__ void stage(const float* __restrict__ img, int wp, int r0, int c0,
                                      int rows, int cols, float* dst) {
  svo::Walk at(threadIdx.x, kThreads, rows, cols);
  for (int e = threadIdx.x; e < rows * cols; e += kThreads, at.advance())
    copy_async4(dst + e, img + static_cast<size_t>(r0 + at.i) * wp + (c0 + at.j));
}

// The (side)^2 window at (r0, c0) of img into dst, with plain loads.
__device__ __forceinline__ void load_window(const float* __restrict__ img, int wp, int r0,
                                            int c0, int side, float* dst) {
  svo::Walk at(threadIdx.x, kThreads, side, side);
  for (int e = threadIdx.x; e < side * side; e += kThreads, at.advance())
    dst[e] = __ldg(img + static_cast<size_t>(r0 + at.i) * wp + (c0 + at.j));
}

// The 4-tap blend of a window (row stride `side`) at (i, j), in the JAX
// kernels' order.
__device__ __forceinline__ float blend(const float* w, int side, int i, int j,
                                       float fy, float fx) {
  const float a = w[i * side + j], b = w[i * side + j + 1];
  const float c = w[(i + 1) * side + j], d = w[(i + 1) * side + j + 1];
  return a * (1.0f - fy) * (1.0f - fx) + b * (1.0f - fy) * fx +
         c * fy * (1.0f - fx) + d * fy * fx;
}

template <bool kCell>
__global__ void __launch_bounds__(kThreads)
lk_level_kernel(const float* __restrict__ prev, const float* __restrict__ next,
                int hp, int wp, const float* __restrict__ pts,
                const float* __restrict__ guess, const uint8_t* __restrict__ active,
                int win, int iters, float eps2, float min_eig, int pad, float radius,
                float* __restrict__ flow, bool* __restrict__ ok_out,
                int32_t* __restrict__ stats) {
  extern __shared__ float smem[];
  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const float gy0 = guess[2 * k + 1];
  const float gx0 = guess[2 * k];
  float vy = 0.0f, vx = 0.0f;
  bool ok = false;
  int it = 0, reloads = 0;
  if (active == nullptr || active[k] != 0) {
    const int r = (win - 1) / 2;
    const float rf = static_cast<float>(r);
    const int s3 = win + 3, s2 = win + 2, s1 = win + 1, ww = win * win;
    const int side = s1 + 2 * kMargin;
    const int rh = min(side, hp), rw = min(side, wp);
    float* buf = smem;              // (win+3)^2: template window, then windows off the region
    float* region = buf + s3 * s3;  // rh x rw pixels of `next` around the guess
    float* field = region + side * side;  // (win+2)^2 blended template field
    float* T = field + s2 * s2;     // win^2 each
    float* Ix = T + ww;
    float* Iy = Ix + ww;
    float* red = Iy + ww;           // kWarps * kMaxSums

    // ---- staging: the template window and the region, one round -------- //
    const float py = pts[2 * k + 1] + static_cast<float>(pad);
    const float px = pts[2 * k] + static_cast<float>(pad);
    const float tbr = py - rf - 1.0f;
    const float tbc = px - rf - 1.0f;
    const int tr0 = floor_clip(tbr, hp - win - 3);
    const int tc0 = floor_clip(tbc, wp - win - 3);
    const float tfy = tbr - static_cast<float>(tr0);
    const float tfx = tbc - static_cast<float>(tc0);
    const int ry0 = min(max(floor_clip(py + gy0 - rf, hp - win - 1) - kMargin, 0), hp - rh);
    const int rx0 = min(max(floor_clip(px + gx0 - rf, wp - win - 1) - kMargin, 0), wp - rw);
    stage(prev, wp, tr0, tc0, s3, s3, buf);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    stage(next, wp, ry0, rx0, rh, rw, region);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // the template window
    __syncthreads();

    // ---- template phase ----------------------------------------------- //
    {
      svo::Walk at(tid, kThreads, s2, s2);
      for (int e = tid; e < s2 * s2; e += kThreads, at.advance())
        field[e] = blend(buf, s3, at.i, at.j, tfy, tfx);
    }
    __syncthreads();
    const svo::Walk w0(tid, kThreads, win, win);  // this thread's first (i, j)
    float g[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // g00 g01 g11 tIx tIy
    {
      svo::Walk at = w0;
      for (int e = tid; e < ww; e += kThreads, at.advance()) {
        const float* f = field + (at.i + 1) * s2 + at.j + 1;
        const float t = f[0];
        const float gx = (f[1] - f[-1]) * 0.5f;
        const float gy = (f[s2] - f[-s2]) * 0.5f;
        T[e] = t;
        Ix[e] = gx;
        Iy[e] = gy;
        g[0] += gx * gx;
        g[1] += gx * gy;
        g[2] += gy * gy;
        g[3] += t * gx;
        g[4] += t * gy;
      }
    }
    // The region's copies landed during the template phase; the reduction's
    // barrier publishes them with T, Ix, Iy.
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    block_sum<5>(g, red);
    const float g00 = g[0], g01 = g[1], g11 = g[2], tIx = g[3], tIy = g[4];
    const float det = g00 * g11 - g01 * g01;
    const float trc = g00 + g11;
    const float mev = (trc - sqrtf(fmaxf(trc * trc - 4.0f * det, 0.0f))) * 0.5f /
                      static_cast<float>(ww);
    ok = mev > min_eig;
    const float safe_det = fabsf(det) < 1e-12f ? 1.0f : det;
    const float inv00 = g11 / safe_det;
    const float inv01 = -g01 / safe_det;
    const float inv11 = g00 / safe_det;

    // ---- iterations --------------------------------------------------- //
    bool running = ok;
    while (running && it < iters) {
      const float br = py + gy0 + vy - rf;
      const float bc = px + gx0 + vx - rf;
      const int iy = floor_clip(br, hp - win - 1);
      const int ix = floor_clip(bc, wp - win - 1);
      // The window: in place in the region, or read into buf. The last reads
      // of buf were before the last reduction's barrier.
      const float* w = buf;
      int ws = s1;
      if (iy >= ry0 && iy + s1 <= ry0 + rh && ix >= rx0 && ix + s1 <= rx0 + rw) {
        w = region + (iy - ry0) * rw + (ix - rx0);
        ws = rw;
      } else {
        load_window(next, wp, iy, ix, s1, buf);
        __syncthreads();
      }
      ++reloads;
      svo::Walk at = w0;
      if (kCell) {
        float s[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        for (int e = tid; e < ww; e += kThreads, at.advance()) {
          const float* q = w + at.i * ws + at.j;
          const float a = q[0], b = q[1], c = q[ws], d = q[ws + 1];
          const float gx = Ix[e], gy = Iy[e];
          s[0] += a * gx;
          s[1] += b * gx;
          s[2] += c * gx;
          s[3] += d * gx;
          s[4] += a * gy;
          s[5] += b * gy;
          s[6] += c * gy;
          s[7] += d * gy;
        }
        block_sum<8>(s, red);
        const float iyf = static_cast<float>(iy), ixf = static_cast<float>(ix);
        bool stay = true;
        while (running && it < iters && stay) {  // uniform: shared totals only
          const float fy = (py + gy0 + vy - rf) - iyf;
          const float fx = (px + gx0 + vx - rf) - ixf;
          const float wy0 = 1.0f - fy, wx0 = 1.0f - fx;
          const float wIx = wy0 * wx0 * s[0] + wy0 * fx * s[1] + fy * wx0 * s[2] +
                            fy * fx * s[3];
          const float wIy = wy0 * wx0 * s[4] + wy0 * fx * s[5] + fy * wx0 * s[6] +
                            fy * fx * s[7];
          const float b0 = tIx - wIx, b1 = tIy - wIy;
          const float dx = inv00 * b0 + inv01 * b1;
          const float dy = inv01 * b0 + inv11 * b1;
          vx += dx;
          vy += dy;
          running = dx * dx + dy * dy > eps2;
          stay = floor_clip(py + gy0 + vy - rf, hp - win - 1) == iy &&
                 floor_clip(px + gx0 + vx - rf, wp - win - 1) == ix;
          ++it;
        }
      } else {
        const float fy = br - static_cast<float>(iy);
        const float fx = bc - static_cast<float>(ix);
        float s[2] = {0.0f, 0.0f};
        for (int e = tid; e < ww; e += kThreads, at.advance()) {
          const float rd = T[e] - blend(w, ws, at.i, at.j, fy, fx);
          s[0] += rd * Ix[e];
          s[1] += rd * Iy[e];
        }
        block_sum<2>(s, red);
        const float dx = inv00 * s[0] + inv01 * s[1];
        const float dy = inv01 * s[0] + inv11 * s[1];
        vx += dx;
        vy += dy;
        running = dx * dx + dy * dy > eps2;
        ++it;
      }
    }
  }
  if (tid == 0) {
    flow[2 * k] = gx0 + vx;
    flow[2 * k + 1] = gy0 + vy;
    ok_out[k] = ok && fabsf(vx) <= radius && fabsf(vy) <= radius;
    if (stats != nullptr) {
      stats[2 * k] = it;
      stats[2 * k + 1] = reloads;
    }
  }
}

template <bool kCell>
int launch(const float* prev, const float* next, int hp, int wp, const float* pts,
           const float* guess, const uint8_t* active, int n, int win, int iters,
           float eps2, float min_eig, int pad, float radius, float* flow, bool* ok,
           int32_t* stats, int device, void* stream) {
  if (n == 0) return 0;
  if (win < 1 || hp < win + 3 || wp < win + 3) return static_cast<int>(cudaErrorInvalidValue);
  svo::DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const int side = win + 1 + 2 * kMargin;
  const size_t floats = static_cast<size_t>((win + 3) * (win + 3) + side * side +
                                            (win + 2) * (win + 2) + 3 * win * win +
                                            kWarps * kMaxSums);
  const size_t smem = floats * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lk_level_kernel<kCell>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lk_level_kernel<kCell><<<n, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      prev, next, hp, wp, pts, guess, active, win, iters, eps2, min_eig, pad, radius, flow,
      ok, stats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int svo_lk_level_cell(const float* prev, const float* next, int hp, int wp,
                                 const float* pts, const float* guess,
                                 const uint8_t* active, int n, int win, int iters,
                                 float eps2, float min_eig, int pad, float radius,
                                 float* flow, bool* ok, int32_t* stats, int device,
                                 void* stream) {
  return launch<true>(prev, next, hp, wp, pts, guess, active, n, win, iters, eps2,
                      min_eig, pad, radius, flow, ok, stats, device, stream);
}

extern "C" int svo_lk_level_v1(const float* prev, const float* next, int hp, int wp,
                               const float* pts, const float* guess,
                               const uint8_t* active, int n, int win, int iters,
                               float eps2, float min_eig, int pad, float radius,
                               float* flow, bool* ok, int32_t* stats, int device,
                               void* stream) {
  return launch<false>(prev, next, hp, wp, pts, guess, active, n, win, iters, eps2,
                       min_eig, pad, radius, flow, ok, stats, device, stream);
}
